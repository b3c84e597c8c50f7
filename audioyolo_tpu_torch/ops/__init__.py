"""Frontend, resampling, NMS and the two kernel wrappers."""
