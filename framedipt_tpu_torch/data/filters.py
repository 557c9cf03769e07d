"""Atom-name predicates of the atom37 convention."""
from __future__ import annotations

from framedipt_tpu_torch.data import constants as rc

BACKBONE_ATOM_NAMES = frozenset({"N", "CA", "C", "O"})


def is_backbone(atom_name: str) -> bool:
    return atom_name in BACKBONE_ATOM_NAMES


def is_ca(atom_name: str) -> bool:
    return atom_name == "CA"


def is_heavy(atom_name: str) -> bool:
    """Every atom37 atom is heavy: the convention holds no hydrogen."""
    return atom_name in rc.atom_order
