"""Resilience layer of the port: fault injection (``faultinject``: the
cascade's kill point, the shard reader's I/O knobs, the live log's and the
serving pool's points), the health monitors (``health``), the deferred
SIGTERM/SIGINT trap (``preempt``) and the retry supervisor
(``supervisor``). Elastic rollback, the host group and the doctor are
ROADMAP Queue 1 item 13b."""
