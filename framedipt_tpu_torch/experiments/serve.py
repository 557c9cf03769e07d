"""Inpainting server on a CUDA device.

Loads the model once (weights stay resident on the card), then serves
inpainting requests over HTTP, one request at a time on the device.

POST /inpaint
    body: {"pdb": "<pdb text>", "chain": "A", "start": 10, "end": 20,
           "samples": 5, "num_t": 100}
    returns: {"samples": ["<pdb text>", ...], "seconds": float}

GET /healthz -> {"status": "ok", "device": "..."}

Usage:
    python -m framedipt_tpu_torch.experiments.serve --port=8900 \
        [--weights=weights/inpainting.pth] [--device=cuda] [config overrides...]

Float32 products run in full float32: TF32 is switched off for matmuls and
cuDNN when the service starts.
"""
from __future__ import annotations

import argparse
import copy
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from framedipt_tpu_torch.analysis.utils import ATOM_MASK_EPS, prot_pos_to_pdb
from framedipt_tpu_torch.data import constants as rc
from framedipt_tpu_torch.data import features as feature_lib
from framedipt_tpu_torch.data import transforms
from framedipt_tpu_torch.data.protein import from_pdb_string, int_to_chain_id
from framedipt_tpu_torch.diffusion import SE3Diffuser
from framedipt_tpu_torch.geometry.rigid import Rigid
from framedipt_tpu_torch.model import ScoreNetwork
from framedipt_tpu_torch.model.kernels.build import build_all
from framedipt_tpu_torch.model.weights import load_reference_checkpoint, synth_state_dict
from framedipt_tpu_torch.sampling import sample
from framedipt_tpu_torch.tools.config import (
    Config,
    load_config,
    merge_checkpoint_config,
    resolve_kernel_flags,
)
from framedipt_tpu_torch.tools.device import resolve_device, set_full_precision_matmul


def _generator(device: torch.device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + stream)


class InpaintingService:
    def __init__(self, cfg: Config, device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        set_full_precision_matmul()
        cfg = copy.deepcopy(cfg)
        state_dict = None
        if cfg.inference.weights_path:
            state_dict, ckpt_conf = load_reference_checkpoint(cfg.inference.weights_path)
            if ckpt_conf:
                cfg = merge_checkpoint_config(cfg, ckpt_conf)
        resolve_kernel_flags(cfg, self.device)
        self.cfg = cfg
        if self.device.type == "cuda":
            build_all()
        self.diffuser = SE3Diffuser(cfg.diffuser, device=self.device)
        self.model = ScoreNetwork(cfg.model, self.diffuser, inpainting=True)
        if state_dict is None:
            print("serving with RANDOM weights (no checkpoint given)", flush=True)
            state_dict = synth_state_dict(self.model, seed=cfg.inference.seed)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self._req_count = 0
        self._lock = threading.Lock()

    def inpaint(
        self, pdb_text: str, chain: str, start: int, end: int,
        samples: int, num_t: int,
    ) -> list[str]:
        """Resample residues [start, end] (0-based, inclusive) of ``chain``
        ``samples`` times; returns one PDB text per sample, in the input's
        coordinate frame."""
        prot = from_pdb_string(pdb_text)
        n = len(prot.aatype)
        sorted_ids = sorted(set(int(c) for c in prot.chain_index))
        letter_for = {cid: int_to_chain_id(i) for i, cid in enumerate(sorted_ids)}
        chain_sel = np.asarray([letter_for[int(c)] == chain for c in prot.chain_index])
        if not chain_sel.any():
            raise ValueError(f"chain {chain!r} not found")
        region_rows = np.where(chain_sel)[0][start : end + 1]
        diffused = np.zeros(n, np.float32)
        diffused[region_rows] = 1.0

        # Sample in a frame centred on the CA centroid, as the batch pipeline
        # featurizes its inputs: the reverse step's centring convention (sum
        # over all residues / diffused count) assumes centred coordinates.
        ca_mask = prot.atom_mask[:, rc.CA_IDX]
        center = (prot.atom_positions[:, rc.CA_IDX] * ca_mask[:, None]).sum(0) / max(
            ca_mask.sum(), 1.0
        )
        positions = (prot.atom_positions - center) * prot.atom_mask[..., None]
        rigids_0 = transforms.backbone_rigid_tensor7(prot.aatype, positions, prot.atom_mask)
        torsions = transforms.atom37_to_torsion_angles(
            prot.aatype, positions, prot.atom_mask
        )["torsion_angles_sin_cos"]
        bucket = feature_lib.length_bucket(n)
        base = {
            "res_mask": prot.atom_mask[:, rc.CA_IDX].astype(np.float32),
            "fixed_mask": (1.0 - diffused).astype(np.float32),
            "seq_idx": np.arange(n, dtype=np.int64),
            "sc_ca_t": np.zeros((n, 3), np.float32),
            "torsion_angles_sin_cos": torsions.astype(np.float32),
            "aatype": prot.aatype.astype(np.int64),
        }
        dev = self.device
        with self._lock:
            req = self._req_count
            self._req_count += 1
            impute = Rigid.from_tensor7(torch.as_tensor(rigids_0, device=dev))
            diffuse_mask = torch.as_tensor(diffused, device=dev)
            entries = []
            for s in range(samples):
                rigids_t = self.diffuser.sample_ref(
                    _generator(dev, self.cfg.inference.seed, req * 997 + s),
                    n_samples=n, impute=impute, diffuse_mask=diffuse_mask,
                )
                item = dict(base, rigids_t=rigids_t.to_tensor7().cpu().numpy())
                entries.append(feature_lib.pad_feats(item, bucket))
            feats = {
                k: torch.as_tensor(np.stack([e[k] for e in entries]), device=dev)
                for k in entries[0]
            }
            d = self.cfg.inference.diffusion
            out = sample(
                self.model, self.diffuser, feats,
                _generator(dev, self.cfg.inference.seed + 1, req),
                num_t=num_t, min_t=d.min_t, noise_scale=d.noise_scale,
                inpainting=True,
            )
            prot_final = out["prot_traj"][0].cpu().numpy()  # t=0, [S, N_pad, 37, 3]
        # Back to the input frame; absent atoms (at the origin) stay absent.
        present = np.abs(prot_final).sum(-1, keepdims=True) > ATOM_MASK_EPS
        prot_final = np.where(present, prot_final + center, 0.0)

        res_mask = base["res_mask"].astype(bool)
        b_factors = np.tile((diffused * 100.0)[:, None], (1, 37))
        return [
            prot_pos_to_pdb(
                prot_final[s][:n][res_mask],
                aatype=prot.aatype[res_mask],
                b_factors=b_factors[res_mask],
                residue_index=prot.residue_index[res_mask],
                chain_index=prot.chain_index[res_mask],
            )
            for s in range(samples)
        ]


def make_handler(service: InpaintingService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # keep request logs off stderr
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "device": str(service.device)})
            else:
                self._json(404, {"error": "not found"})

        def do_POST(self):
            if self.path != "/inpaint":
                self._json(404, {"error": "not found"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                t0 = time.perf_counter()
                pdbs = service.inpaint(
                    pdb_text=req["pdb"],
                    chain=req.get("chain", "A"),
                    start=int(req["start"]),
                    end=int(req["end"]),
                    samples=int(req.get("samples", 1)),
                    num_t=int(req.get("num_t", 100)),
                )
                self._json(200, {"samples": pdbs, "seconds": time.perf_counter() - t0})
            except Exception as e:  # noqa: BLE001 - report the failure to the client
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8900)
    ap.add_argument("--weights", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*")
    args = ap.parse_args()
    cfg = load_config(args.overrides)
    cfg.inference.weights_path = args.weights
    service = InpaintingService(cfg, device=args.device)
    server = ThreadingHTTPServer(("127.0.0.1", args.port), make_handler(service))
    print(f"serving on http://127.0.0.1:{args.port} ({service.device})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
