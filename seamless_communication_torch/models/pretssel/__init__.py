"""PRETSSEL, SeamlessExpressive's vocoder, and its ECAPA-TDNN prosody encoder."""
