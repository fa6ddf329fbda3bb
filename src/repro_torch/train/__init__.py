"""Training (twin of ``repro.train``): the train step and the
fault-tolerant loop."""
