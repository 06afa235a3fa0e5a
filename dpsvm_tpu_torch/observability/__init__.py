"""Observability layer of the port: the metric registry and the data
layer's instruments (``metrics``) so far; the rest of
``dpsvm_tpu/observability`` is ROADMAP Queue 1 item 13."""
