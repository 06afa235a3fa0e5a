"""Resilience layer of the port: only fault injection (``faultinject``:
the cascade's kill point and the shard reader's I/O knobs) so far; the rest
of ``dpsvm_tpu/resilience`` is ROADMAP Queue 1 item 13."""
