"""Host-side data: chemical constants, PDB IO, featurization, padding."""
