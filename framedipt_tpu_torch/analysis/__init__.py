"""PDB writers for sampled structures."""
