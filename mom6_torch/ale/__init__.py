"""Arbitrary Lagrangian-Eulerian vertical coordinate: regrid the column to
a target coordinate, then remap the state onto it conservatively.

Counterpart of ``mom6_tpu.ale``, with every coordinate (the HYCOM hybgen
generator and its unmixing, and ADAPTIVE, among them) and every remap
scheme.  Plain PyTorch: no Pallas kernel lies on this path in the JAX
package either.
"""
