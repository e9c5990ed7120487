"""The port's write tier (``serve/ingest.py``, ``serve/write_session.py``)
and audit plane (``obs/audit.py``) through the JAX package's own tests.

Every case of ``tests/test_write_tier.py`` and ``tests/test_audit.py``
runs again through the port (`torch_twins.port_copies`; the engines, the
law fixtures and the write sessions' pre-wire compaction run on the CPU
inside ``host_device``). The audit CLI tests load
``scripts/ccrdt_audit.py`` as they do in JAX, with its audit module
pointed at the port's, so the CLI certifies and verifies through the
port. The direct comparisons with JAX (acks, events, certificates) are in
``tests/test_torch_serve_jax.py``.
"""

import pytest

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from torch_twins import port_copies

globals().update(port_copies(
    ("test_write_tier.py", dict(replace=[
        ('jnp = pytest.importorskip("jax.numpy")', "from torch_twins import torch_jnp as jnp"),
    ])),
    ("test_audit.py", dict(replace=[
        ("    spec.loader.exec_module(mod)\n    return mod",
         "    spec.loader.exec_module(mod)\n"
         "    from antidote_ccrdt_tpu_torch.obs import audit as port_audit\n\n"
         "    mod.obs_audit = port_audit\n    return mod"),
    ])),
))


@pytest.fixture(autouse=True)
def _engines_on_the_cpu():
    """Entry points called without a device run their plain path."""
    with host_device():
        yield
