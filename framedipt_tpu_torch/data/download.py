"""RCSB structure downloads: mmCIF files (the first biological assembly by
default) fetched by a thread pool. Without a network each download raises
:class:`ConnectionError`; ``download_cifs`` logs it and goes on."""
from __future__ import annotations

import concurrent.futures
import pathlib
import urllib.error
import urllib.request

from framedipt_tpu_torch.tools.log import get_logger

logger = get_logger()

RCSB_URL = "https://files.rcsb.org/download"


def cif_name(pdb_id: str, first_assembly: bool = True) -> str:
    """The file name of ``pdb_id``'s mmCIF, locally and at RCSB."""
    return f"{pdb_id.lower()}-assembly1.cif" if first_assembly else f"{pdb_id.lower()}.cif"


def download_cif(
    pdb_id: str,
    out_dir: str | pathlib.Path,
    first_assembly: bool = True,
    timeout: float = 30.0,
) -> pathlib.Path:
    """``pdb_id``'s mmCIF in ``out_dir``, downloaded unless present."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = cif_name(pdb_id, first_assembly)
    target = out_dir / name
    if target.exists():
        return target
    url = f"{RCSB_URL}/{name}"
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            target.write_bytes(resp.read())
    except (urllib.error.URLError, OSError) as e:
        raise ConnectionError(f"failed to download {url} (offline environment?): {e}") from e
    return target


def download_cifs(
    pdb_ids: list[str],
    out_dir: str | pathlib.Path,
    first_assembly: bool = True,
    max_workers: int = 8,
) -> list[pathlib.Path]:
    """The files of ``pdb_ids`` that are present or were downloaded, in order
    of completion; a failed download is logged and skipped."""
    results: list[pathlib.Path] = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = {pool.submit(download_cif, pid, out_dir, first_assembly): pid
                   for pid in pdb_ids}
        for fut in concurrent.futures.as_completed(futures):
            try:
                results.append(fut.result())
            except ConnectionError as e:
                logger.warning(f"{futures[fut]}: {e}")
    return results
