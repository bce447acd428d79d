"""Tools of the port: the scatter probe (``python -m
deequ_tpu_torch.tools.scatter_probe``) and its kernels."""
