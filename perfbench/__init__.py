"""The benchmark of ``audioyolo_tpu_torch`` on one CUDA card (see ``run.py``)."""
