"""Export a port checkpoint to the reference's PyTorch ``.pt`` layout.

A model trained in the port loads into the reference code: the DT export
into its ``DecisionTransformer`` with ``load_state_dict(strict=True)``
(masking buffers included with ``--block_size``), the U-Net export into its
``UNet``; the JAX package's ``load_dt_checkpoint`` / ``load_unet_checkpoint``
read both.

    python -m dt4image_restoration_tpu_torch.tools.export_checkpoint \\
        --model dt --in ckpts/state_latest.pt --out dt_export.pt \\
        --block_size 18
    python -m dt4image_restoration_tpu_torch.tools.export_checkpoint \\
        --model unet --in unet_port.pt --out unet_export.pt

``--in`` takes a port model state dict saved with ``torch.save`` or the
trainer's ``state_latest.pt``, whose model weights are taken out. Host
work only: it runs on the CPU.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m dt4image_restoration_tpu_torch.tools."
             "export_checkpoint",
        description=__doc__.splitlines()[0])
    p.add_argument("--model", required=True, choices=["dt", "unet"])
    p.add_argument("--in", dest="src", required=True,
                   help="port state dict .pt, or the trainer's "
                        "state_latest.pt")
    p.add_argument("--out", required=True, help="output .pt path")
    p.add_argument("--block_size", type=int, default=None,
                   help="emit per-block causal 'masking' buffers of this "
                        "size so the reference DT accepts the export with "
                        "strict=True (reference runs use 18)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from ..utils.checkpoint import restore_checkpoint, save_checkpoint
    from ..utils.convert import dt_to_reference, unet_to_reference

    sd = restore_checkpoint(args.src)
    if isinstance(sd.get("model"), dict):   # the trainer's full state
        sd = sd["model"]
    if args.model == "dt":
        out = dt_to_reference(sd, block_size=args.block_size)
    else:
        out = unet_to_reference(sd)
    save_checkpoint(args.out, out)
    print(f"wrote {len(out)} tensors to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
