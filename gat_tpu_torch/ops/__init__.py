"""DSP ops of the port: mel filterbanks, pitch names, spectral front-end
and YIN."""
