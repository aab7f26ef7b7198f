"""Command line of the port: ``python -m nornicdb_tpu_torch <command>``.

The counterpart of ``nornicdb_tpu/cli.py``, one subcommand at a time as the
slices port what each drives. Ported: ``train``. ``--device`` is the port's
device argument: it defaults to the card (CUDA) and names the CPU only when
asked (``--device cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_train(args) -> int:
    """Train an in-image checkpoint (``models/pretrain.py``) with the JAX
    package's presets, and print its stats as one JSON line."""
    from nornicdb_tpu_torch.models import pretrain

    if args.model == "assistant":
        # facts + ACTION-MODE corpus: the served assistant must emit
        # machine-parseable query/status actions
        corpus = (pretrain.synth_corpus(0, repeats=6)
                  + pretrain.synth_action_corpus(0, repeats=6))
        stats = pretrain.train_assistant(
            args.out, steps=args.steps or 1400, batch=24, seq_len=64,
            hidden=128, lr=2e-3, corpus=corpus, device=args.device,
        )
    else:
        stats = pretrain.train_encoder(args.out, steps=args.steps or 250,
                                       device=args.device)
    print(json.dumps({"model": args.model, "out": args.out, **stats}))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="nornicdb_tpu_torch",
        description="NornicDB's PyTorch/CUDA port")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser(
        "train",
        help="train in-image model checkpoints (assistant decoder via LM "
             "loss, embedding encoder via InfoNCE) on the synthetic domain "
             "corpus — the zero-egress replacement for mounting GGUF weights",
    )
    s.add_argument("model", choices=["assistant", "encoder"])
    s.add_argument("--out", required=True, help="checkpoint output directory")
    s.add_argument("--steps", type=int, default=0,
                   help="train steps (default: per-model preset)")
    s.add_argument("--device", default=None,
                   help="torch device to train on (default: cuda; 'cpu' only "
                        "when named)")
    s.set_defaults(fn=cmd_train)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
