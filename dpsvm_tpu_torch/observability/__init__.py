"""Observability layer of the port: the metric registry, its exposition
validator and the data layer's instruments (``metrics``), request span
trees (``spans``), the run-trace format and the serving trace (``schema``,
``record``), the perf ledger (``ledger``), SLO rules and the watchtower
(``slo``), and the flight recorder with its incident bundles
(``blackbox``). The training driver's run trace, compile/capture
accounting, the profiler, roofline, report/compare/merge and the fleet
views are ROADMAP Queue 1 item 13."""
