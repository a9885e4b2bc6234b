"""Runnable tools: the counterparts of ``scripts/lint_traces.py``,
``scripts/profile_train.py`` and ``scripts/perf_report.py --trace-dir``
(``python -m thunder_tpu_torch.scripts.lint_traces``, ...). Importing a module
here does nothing; the work sits under ``main()``."""
