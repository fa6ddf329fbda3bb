"""Entry points: ``python -m repro_torch.launch.serve`` (quantize and
serve a batch of requests) and ``python -m repro_torch.launch.daemon``
(wall-clock serving through the ``ServingDaemon``)."""
