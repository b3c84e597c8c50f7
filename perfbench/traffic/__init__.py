"""Frozen traffic generators: audio and directories of WAV files."""
