"""VAD segmentation of long audio (host numpy)."""
