"""DSP ops of the port: mel filterbanks, pitch names, spectral front-end,
YIN, resampling, windowed filters and onset detection."""
