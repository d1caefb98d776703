"""Readings that set a cell's limits: the program's numbers against the
plain reference, and the control's (the reference itself in the program's
place, computed one precision below the configuration's: the denoiser's
products through fp8 e4m3, the fp32 VAE and CLIP in TF32) and a planted
fault's, on each seed given.

    python3 port_bench/control.py --workload <cell> --seeds 1 2 3 [--fault half_batch]

Serving compares request 0 (the latents: the trajectory in fp8; the
decode: the VAE in TF32 on the program's latents), over the frames a run's
check recomputes; a training cell its first `check_steps` steps.
`--fault half_batch` (training) puts the reference in the program's place
with the second half of every batch left out (half the clips; of a batch of
one clip, half its frames), the mean taken over the rest. The reference is
the configuration's family (`harness.spec.reference_family`). Prints one
JSON line per seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serve_readings(cell, seed: int, device: str, decode_only: bool = False) -> dict:
    import torch

    from port_bench.harness import check
    from port_bench.harness import weights as W
    from port_bench.harness.serve import ServeCell
    from port_bench.reference.model import Numerics

    drv = ServeCell(cell.config, cell.traffic, seed, device)
    drv.setup()
    rows = drv.check_rows(0)
    images = check.rows_of(drv.request(0, cell.traffic["steps"]).float().cpu(), rows)
    latents = drv._latents.float().cpu()
    drv.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    # the decode stage on the program's latents: fp32, and one precision lower (TF32)
    vae = W.reference_on(drv.config, seed, device)["vae"]
    lat = check.rows_of(latents, rows).to(device)
    ref_img = drv.family.decode(vae, lat, drv.model_cfg, Numerics()).float().cpu()
    tf32 = drv.family.decode(vae, lat, drv.model_cfg, Numerics("fp8")).float().cpu()
    del vae
    out = {"program": {"decode_gap": check.frame_gap(images, ref_img)},
           "control": {"decode_gap": check.frame_gap(tf32, ref_img)}}
    if not decode_only:
        ref_lat, _, _ = drv.reference(0, Numerics())
        c_lat, _, _ = drv.reference(0, Numerics("fp8"))
        out["program"]["latent_gap"] = check.frame_gap(check.rows_of(latents, rows), ref_lat)
        out["control"]["latent_gap"] = check.frame_gap(c_lat, ref_lat)
    return out


def halve(drv) -> None:
    """Leave the second half of each of `drv`'s batches out: half the
    clips, or of a batch of one clip the second half of its frames (its
    reference then trains on clips of that many frames)."""
    full, f = drv.inputs, drv.frames
    clips = drv.batch_rows // f
    if clips > 1:
        clips //= 2
    else:
        f //= 2
        drv.train_cfg = {**drv.train_cfg, "video_frames": f}
    cut = {"reference": clips, "vae_reference": clips}

    def inputs(i, device=None):
        batch, draws = full(i, device)
        return ({k: v[:cut.get(k, clips * f)] for k, v in batch.items()},
                {k: v[:cut.get(k, clips * f)] for k, v in draws.items()})

    drv.inputs = inputs


def train_readings(cell, seed: int, device: str, fault: str = "") -> dict:
    import torch

    from port_bench.harness import check
    from port_bench.harness.train import TrainCell
    from port_bench.reference.model import Numerics

    drv = TrainCell(cell.config, cell.traffic, seed, device)
    drv.setup()
    got = drv.readings
    drv.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = drv.reference(Numerics(remat=True))
    out = {"program": check.train_numbers(got, want),
           "control": check.train_numbers(drv.reference(Numerics("fp8", remat=True)), want)}
    if fault == "half_batch":
        halve(drv)
        out["half_batch"] = check.train_numbers(drv.reference(Numerics(remat=True)), want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="", choices=("", "half_batch"))
    ap.add_argument("--decode-only", action="store_true",
                    help="serving: only the decode stage's control (no fp8 trajectory)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.harness.spec import load_cell

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    for seed in args.seeds:
        if cell.traffic["kind"] == "serve":
            r = serve_readings(cell, seed, "cuda", args.decode_only)
        else:
            r = train_readings(cell, seed, "cuda", args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
