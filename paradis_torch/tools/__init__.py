"""Diagnostic scripts of the port that run on a CUDA card (``python3 -m
paradis_torch.tools.<name>``); nothing here runs at import."""
