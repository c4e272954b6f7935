"""Export CLI (the JAX package's ``cli/export.py``): ``torch.export``
bundles of the recognizer and the char LM (``serve/export.py``).

    python -m handwritten_chinese_ocr_samples_torch.cli.export \\
        -m hctr -f <weights.pt | seed:<n>> -o exported/ -w 512,1024,1600 \\
        [-b 4] [-cl chars_list.txt] [--int8-calib <img dir>] \\
        [-tp <lm dir | seed:<n>>] [--device cuda]

``-f`` takes what ``cli/deploy.py -m`` takes: a ``torch.save``d state dict,
a checkpoint of the port's trainer, a reference ``.pth``/``.pth.tar``
checkpoint, or ``seed:<n>``. The programs are traced
on ``--device`` and run there only. ``--int8-calib`` calibrates the conv
sites on the first 16 images of a folder at the first width and exports the
int8 forward with the scales baked in.
"""

from __future__ import annotations

import argparse


def build_argparser():
    parser = argparse.ArgumentParser(description="HCTR model export "
                                                 "(PyTorch)")
    args = parser.add_argument_group("Options")
    args.add_argument("-m", "--model-type", type=str, default="hctr",
                      choices=["hctr", "hctr-tiny"], help="model tag")
    args.add_argument("-f", "--model-file", type=str, default="",
                      metavar="PATH", help="torch state dict (.pt), a "
                      "checkpoint of the port's trainer, a reference "
                      ".pth/.pth.tar, or 'seed:<n>'")
    args.add_argument("-o", "--out-dir", type=str, default="exported",
                      help="output directory")
    args.add_argument("-w", "--widths", type=str, default="512,1024,1600",
                      help="comma-separated export width buckets")
    args.add_argument("-b", "--batch-sizes", type=str, default="1",
                      help="comma-separated export batch sizes")
    args.add_argument("-cl", "--chars-list", type=str, default=None,
                      help="chars_list.txt path")
    args.add_argument("--int8-calib", dest="int8_calib", type=str,
                      default="", metavar="DIR",
                      help="folder of calibration line images: export "
                           "int8-conv programs with the scales baked in")
    args.add_argument("-tp", "--tfm-path", dest="tfm_path", type=str,
                      default="", help="char LM to export alongside: a "
                      "directory (config.json, dict.txt, weights.pt) or "
                      "'seed:<n>'")
    args.add_argument("--lm-lengths", type=str, default="32,64",
                      help="comma-separated LM token-length buckets")
    args.add_argument("--lm-batch-sizes", type=str, default="1,10",
                      help="comma-separated LM batch buckets")
    args.add_argument("--device", type=str, default="cuda",
                      help="torch device the programs are traced on")
    return parser


def _ints(csv: str):
    return tuple(int(v) for v in csv.split(","))


def main(argv=None):
    """Returns ``{"model": meta, "lm": meta}`` of what was exported."""
    parser = build_argparser()
    args = parser.parse_args(argv)
    if not args.model_file and not args.tfm_path:
        parser.error("nothing to export: pass -f and/or -tp")
    import torch
    from ..core.codec import load_chars_list

    out = {}
    characters = (load_chars_list(args.chars_list) if args.chars_list
                  else None)
    if args.model_file:
        from ..models.registry import get_model_info
        from ..serve.export import export_model
        from .deploy import load_weights

        model, characters = get_model_info(
            args.model_type, chars_list_file=args.chars_list,
            dtype=torch.bfloat16)
        state = load_weights(args.model_file, model)
        widths = _ints(args.widths)

        quant = None
        if args.int8_calib:
            from ..serve.quant import calibrate_for_model, calibration_images
            try:
                batch = calibration_images(args.int8_calib, model.img_height,
                                           widths[0])
            except ValueError as e:
                raise SystemExit(f"--int8-calib: {e}")
            model.load_state_dict(state)
            model.to(args.device).eval()
            x = torch.from_numpy(batch).to(args.device)
            quant = calibrate_for_model(model, [(x.float() - 127.5) / 127.5])

        meta = export_model(
            model, state, args.out_dir, tag=args.model_type, widths=widths,
            batch_sizes=_ints(args.batch_sizes),
            unknown_id=len(characters) + 1, quant=quant, device=args.device)
        print(f"exported: {meta['artifacts']} -> {args.out_dir}")
        out["model"] = meta

    if args.tfm_path:
        from ..lm.io import load_lm
        from ..serve.export import export_lm

        lm_model, lm_state, tokenizer = load_lm(args.tfm_path,
                                                chars_list=characters)
        meta = export_lm(
            lm_model, lm_state, tokenizer, args.out_dir,
            batch_sizes=_ints(args.lm_batch_sizes),
            lengths=_ints(args.lm_lengths), device=args.device)
        print(f"exported LM: {meta['artifacts']} -> {args.out_dir}")
        out["lm"] = meta
    return out


if __name__ == "__main__":
    main()
