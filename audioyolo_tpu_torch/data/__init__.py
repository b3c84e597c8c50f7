"""Host-side audio IO: WAV reading, the native batch decoders, datasets and
the batch loader."""
