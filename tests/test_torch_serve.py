"""The port's read tier (``serve/{cache,routing_common,session,replica,
kernels,plane,router}.py``) through the JAX package's own tests.

Every case of ``tests/test_serve.py``, ``tests/test_serve_staleness.py``
and ``tests/test_router.py`` runs again through the port
(`torch_twins.port_copies`; the engines run on the CPU inside
``host_device``, ``jax.numpy`` op constructors become `torch_twins.torch_jnp`,
``scripts/elastic_demo.py``'s drills `torch_twins.DEMO_DRILLS`). The
direct comparisons with JAX (answer bytes, views, routers across the two
packages) are in ``tests/test_torch_serve_jax.py``.
"""

import pytest
import torch

from antidote_ccrdt_tpu_torch.core.batch_merge import host_device
from torch_twins import port_copies

_JNP = ("import jax.numpy as jnp", "from torch_twins import torch_jnp as jnp")
_JNP_SKIP = ('jnp = pytest.importorskip("jax.numpy")', "from torch_twins import torch_jnp as jnp")
_SERVE = ("from antidote_ccrdt_tpu import serve", "from antidote_ccrdt_tpu_torch import serve")

globals().update(port_copies(
    ("test_serve.py", dict(replace=[_JNP, _SERVE])),
    ("test_serve_staleness.py", dict(replace=[
        _SERVE,
        ("from elastic_demo import DRILLS, R", "from torch_twins import DEMO_DRILLS as DRILLS, R"),
        ("from tests.test_serve import _engine", "from torch_twins import serve_engine as _engine"),
    ])),
    ("test_router.py", dict(replace=[_JNP_SKIP, _SERVE])),
))


@pytest.fixture(autouse=True)
def _engines_on_the_cpu():
    """Entry points called without a device run their plain path."""
    with host_device():
        yield


def test_served_fleet_drill_holds_and_repeats_on_the_cpu():
    """chip_smoke.py phase 13's served fleet at its reduced width on the
    CPU (three TcpTransport workers, WAL-backed durable and
    replicated_to_k acks, the hot key's owner failing): every gate holds,
    and a second run gives the same answer bytes, read-backs,
    certificates and digests, which is what the card run is held to."""
    import json

    import chip_smoke

    runs = []
    for _ in range(2):
        with chip_smoke.frozen_wall_clock():
            runs.append(chip_smoke.run_fleet(torch, "cpu", chip_smoke.FLEET_SMALL, storm=False))
        chip_smoke.check_fleet(runs[-1], "the reduced fleet", storm=False)
    a, b = runs
    assert a["victim"] not in a["survivors"] and a["folds"] > 0
    for key in ("answers", "digests", "ref"):
        assert a[key] == b[key], key
    for key in ("wcert", "scert"):
        assert json.dumps(a[key], sort_keys=True) == json.dumps(b[key], sort_keys=True), key
    assert [st["read_docs"] for st in a["stats"]] == [st["read_docs"] for st in b["stats"]]
