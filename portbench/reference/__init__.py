"""The benchmark's plain reference: a bootstrap filter in plain PyTorch
(``filter.py``), its resampler laws one file each (``resamplers/``), and
the Kalman filter in NumPy (``kalman.py``). None imports the program
under test."""
