"""The single-device samples of ``cuba_tpu`` (``samples/``) on the port, run
as ``python -m cuba_tpu_torch.samples.<name>``: on the card unless given
``--cpu``."""
