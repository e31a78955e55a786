"""Plain references, one file per compressor family:
compress(algorithm, data, config, device) -> the container the program must
return. Plain numpy and PyTorch; nothing of the program, nor jax."""
