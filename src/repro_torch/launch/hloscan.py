"""Collective and tensor scan of one dry-run cell (the reference's
``repro.launch.hloscan``, kept under its name so a reader finds the
counterpart).  The port has no HLO: this scans the collectives the traced
step issues (:class:`~repro_torch.launch.roofline.StepRecorder`) and its
largest local tensors.

  python -m repro_torch.launch.hloscan --arch granite-8b --shape train_4k
  python -m repro_torch.launch.hloscan --arch granite-8b --shape train_4k \
      --layers 1      # one layer at full width: seconds, not minutes
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys

from repro_torch.configs import SHAPES, get_config


def scan(recorder, top: int = 15) -> list:
    """Report lines: the top collectives by wire bytes per device, summed
    over the calls of one kind, group size and output shape issued at one
    place, with their count; the largest single local tensors; the total
    t_coll."""
    sites: dict = {}
    for wire, kind, n, nbytes, where, what in recorder.records:
        key = (kind, n, where, what)
        w, c = sites.get(key, (0.0, 0))
        sites[key] = (w + wire, c + 1)
    lines = ["== top collectives (wire bytes per device, summed over the "
             "calls issued at one place) =="]
    for (kind, n, where, what), (wire, count) in sorted(
            sites.items(), key=lambda kv: -kv[1][0])[:top]:
        lines.append(f"{wire / 1e9:10.3f} GB  {kind:14} group={n:3} "
                     f"count={count:5}  {where}  {what}")
    lines.append("== largest single local tensors ==")
    for nbytes, op, shape, dtype in sorted(recorder.largest,
                                           reverse=True)[:top]:
        lines.append(f"{nbytes / 1e9:10.3f} GB  {op:40} {dtype} "
                     f"{list(shape)}")
    st = recorder.stats
    lines.append(f"total wire: {st.wire_bytes / 1e9:.2f} GB in "
                 f"{len(recorder.records)} collectives -> "
                 f"t_coll={st.seconds:.4f} s")
    return lines


def main(argv=None) -> int:
    from repro_torch.launch.dryrun import (init_fake_world, production_mesh,
                                           trace_cell)

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a multiple of "
                         "the arch's period); default: the whole model")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    init_fake_world(512 if args.multi_pod else 256)
    mesh = production_mesh(multi_pod=args.multi_pod)
    got = trace_cell(cfg, SHAPES[args.shape], mesh, arch=args.arch)
    for line in scan(got["recorder"], args.top):
        print(line)
    print(f"{cfg.n_layers} layers traced in {got['trace_seconds']:.1f} s on "
          f"the {'x'.join(map(str, mesh.shape))} mesh of "
          f"{math.prod(mesh.shape)} ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
