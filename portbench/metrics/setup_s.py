"""Process start to the window's start (host clock): imports, the CUDA
context, the kernel from the checkout's build cache, the inputs, and the
warm-up at the cell's own shapes."""


def read(rec):
    return rec["setup_s"]
