"""Resilience layer of the port: only the cascade's kill point
(``faultinject``) so far; the rest of ``dpsvm_tpu/resilience`` is ROADMAP
Queue 1 item 13."""
