"""Runnable examples: the counterparts of ``examples/train.py`` and
``examples/train_fsdp.py`` (``python -m thunder_tpu_torch.examples.train``,
``python -m thunder_tpu_torch.examples.train_fsdp``). Importing a module
here does nothing; the work sits under ``main()``."""
