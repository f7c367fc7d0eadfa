"""SGPR and CGLB models (fp64)."""
