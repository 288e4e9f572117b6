"""Multi-device bundle adjustment: landmark-sharded LM over a
``torch.distributed`` process group (port of ``cuba_tpu/parallel/``)."""
