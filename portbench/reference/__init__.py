"""Plain float32 PyTorch reference of 48 kHz zero-shot TTS.

Independent of the served program: it imports nothing of it, runs no
kernel, cache or batch, and takes only the benchmark's inputs, weights
and the served outputs it judges."""
