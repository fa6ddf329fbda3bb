"""Entry points: ``python -m repro_torch.launch.serve`` (quantize and
serve a batch of requests), ``python -m repro_torch.launch.daemon``
(wall-clock serving through the ``ServingDaemon``),
``python -m repro_torch.launch.train`` (the fault-tolerant training loop)
and ``python -m repro_torch.launch.elastic`` (training under restart
supervision)."""
