"""K2's share of its roofline in %: the bound of every call recorded in the
traced window (perfbench/work.py over the valid frames or keys, operations at
the TF32 peak or bytes at the HBM bandwidth) over the device time of the
operations launched inside its `perfbench.k2` ranges."""


def read(view):
    return view.roofline("k2")
