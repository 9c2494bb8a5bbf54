"""Layer: SCP loop (``torch_scp.py``). Mean SCP iterations a solve over the
traced window's solves, read from the solver's ``info["iters"]``."""


def read(rec):
    its = [i for s in rec["solves"] for i in s["iters"]]
    return sum(its) / len(its) if its else None
