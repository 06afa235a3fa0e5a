"""The benchmark of ``dpsvm_tpu_torch`` on an NVIDIA GPU: the harness
(``run.py``, ``core.py``), its traffic generators (one a kind, under
``kinds/``), the plain reference the check compares with
(``reference.py``), the yardstick's frozen arithmetic (``data.py``,
``roofline.py``), the trace reduction (``trace.py``), and the data it is
driven by: ``configs/``, ``traffic/``, ``limits/`` and one reader a
per-layer metric under ``metrics/``. See ``README.md``."""
