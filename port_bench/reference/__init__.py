"""A frozen plain-PyTorch copy of the PARADIS mathematics, float32 by default.

The yardstick that decides ``correct``: the model forward (``model.py``),
the weighted reversed Huber loss (``loss.py``), NorMuon + AdamW
(``optim.py``) and the forecast rollout.  It imports nothing of the program
and takes none of its tables: every grid, weight and position is worked out
here from the configuration file and the tensors the benchmark draws.
"""
