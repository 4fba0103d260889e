"""The benchmark of ``selfrec_tpu_torch``: its harness, plain references,
configurations, traffic mixes and metric readers (see ``run.py``)."""
