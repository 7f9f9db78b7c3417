from repro_torch.kernels import ops  # noqa: F401
