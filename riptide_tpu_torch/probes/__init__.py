"""
Chip probes: the card's time for the primitives the fused FFA kernel is
built from, ported from the JAX package's Pallas probes.

==========================  ============================  =================
module                      replaces                      entry point
==========================  ============================  =================
:mod:`.ptime` (P1)          ``tools/ptime.py:86``         ``python -m
                                                          riptide_tpu_torch.
                                                          probes.ptime``
:mod:`.ptime2` (P2)         ``tools/ptime2.py:28``        ``... .ptime2``
:mod:`.probe1536` (P3)      ``tools/probe1536.py:84``     ``... .probe1536``
==========================  ============================  =================

Their kernels are in ``riptide_tpu_torch/csrc/probes.cu``, built and
launched through :mod:`.common`. The entry points run on the card unless
``--device cpu`` asks for the plain versions.
"""
