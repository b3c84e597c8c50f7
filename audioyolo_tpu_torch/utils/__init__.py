"""Small utilities of the port (port of ``audioyolo_tpu/utils``)."""
from .logging import LOG_DATE_FORMAT, LOG_FORMAT, setup_logging  # noqa: F401
