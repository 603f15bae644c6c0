"""The port's training loop (``runtime/trainer.py``)."""
