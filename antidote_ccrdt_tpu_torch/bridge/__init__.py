"""Bridge plane: the Erlang-facing wire protocol (``bridge.protocol``,
the ``{packet, 4}`` framing and ETF request terms that ``net.tcp`` also
speaks). The server and client of the JAX package's bridge are not
ported yet (ROADMAP A9)."""
