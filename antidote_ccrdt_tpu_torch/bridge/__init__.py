"""Bridge plane: the Erlang-facing wire protocol (``bridge.protocol``, the
``{packet, 4}`` framing and ETF request terms that ``net.tcp`` also
speaks), the threaded bridge server a BEAM host drives (scalar handles
and named dense grids of all six types on the server's device) and its
blocking client."""

from .client import BridgeClient  # noqa: F401
from .server import BridgeServer  # noqa: F401
