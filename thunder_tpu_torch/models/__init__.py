"""Models written against the port's torch language."""

from thunder_tpu_torch.models import gpt  # noqa: F401
