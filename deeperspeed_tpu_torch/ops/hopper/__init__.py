"""Hand-written Hopper (sm_90a) kernels of the port, each beside its
plain PyTorch version and a launch counter. Sources live in
`deeperspeed_tpu_torch/csrc`; `_build` compiles them at first use."""
