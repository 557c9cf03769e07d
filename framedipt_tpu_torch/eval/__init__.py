"""Evaluation of the inpainting CLI's output tree: region metrics, sample
selection, the TCR evaluation CLI (``tcr_eval``) and residue renumbering."""
