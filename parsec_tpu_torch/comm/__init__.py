"""Communication layer, Python side: for now only the JAX-free models
the static analyses price with, the fitted transfer economics
(`economics`) and the hosts-and-islands topology (`topology`).

Port of parsec_tpu/comm (those two modules).  The comm engine itself
(Context.comm_*, the launcher, the collectives, the device data plane)
is not ported yet: a context here is one rank.
"""
