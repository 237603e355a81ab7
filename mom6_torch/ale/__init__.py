"""Arbitrary Lagrangian-Eulerian vertical coordinate: regrid the column to
a target coordinate, then remap the state onto it conservatively.

Counterpart of ``mom6_tpu.ale`` without the HYCOM hybgen generator, its
unmixing and its remap schemes, and without the ADAPTIVE coordinate;
those raise ``NotImplementedError`` naming themselves.  Plain PyTorch:
no Pallas kernel lies on this path in the JAX package either.
"""
