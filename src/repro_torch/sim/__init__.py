"""RAMSES-like AMR data substrate (Sedov3D + Orion-like generators)."""
