"""Serving front-ends: the LM stack's serving steps (serve_step), the
async micro-batched cluster-configuration service (config_service), the
socket-level HTTP/ASGI edge for Hub Gateway API v1 (edge), and the
closed-loop load generator that drives it (loadgen)."""
