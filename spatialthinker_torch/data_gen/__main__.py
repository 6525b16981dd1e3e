"""CLI: python3 -m spatialthinker_torch.data_gen <command> [...]

The JAX package's ``python -m spatialthinker_tpu.data_gen``, command for
command:
  preprocess   LLM question generation over VG scene graphs
               (``datasets`` loads them; ANTHROPIC_API_KEY)
  build-hf     balance / select / shuffle into the HF training set
  validate     LLM cross-validation, pass@k (OPENAI_API_KEY)
  splits       easy / hard level splits
  stats        category / level distribution of a CSV
Each reads and writes CSV files through ``pandas``.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    """Run one command; ``argv`` defaults to the process's arguments."""
    parser = argparse.ArgumentParser(prog="spatialthinker_torch.data_gen")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("preprocess")
    p.add_argument("--data-cap", type=int, default=None)
    p.add_argument("--out", default="data/spatialthinker_vqa_train.csv")
    p.add_argument("--model", default="claude-sonnet-4-20250514")
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--resume-csv", default=None)

    p = sub.add_parser("build-hf")
    p.add_argument("--csv", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--target-size", type=int, default=10_000)
    p.add_argument("--relation-fraction", type=float, default=0.5)

    p = sub.add_parser("validate")
    p.add_argument("--csv", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="gpt-4o")
    p.add_argument("--attempts", type=int, default=2)

    p = sub.add_parser("splits")
    p.add_argument("--csv", required=True)
    p.add_argument("--out-prefix", required=True)

    p = sub.add_parser("stats")
    p.add_argument("--csv", required=True)

    args = parser.parse_args(argv)
    import pandas as pd

    from . import pipeline
    from .llm import call_anthropic, call_openai_vision

    if args.cmd == "preprocess":
        import datasets

        ds = datasets.load_dataset(pipeline.SOURCE_DS, split="train")
        if args.data_cap:
            ds = ds.select(range(args.data_cap))
        resume_rows = (
            pd.read_csv(args.resume_csv).to_dict("records") if args.resume_csv else None
        )
        if resume_rows:
            ds = ds.select(range(len(resume_rows), len(ds)))
        call = lambda prompt: call_anthropic(prompt, model=args.model, temperature=args.temperature)
        pipeline.generate_questions(call, ds, out_csv=args.out, resume_rows=resume_rows)
    elif args.cmd == "build-hf":
        rows = pd.read_csv(args.csv).to_dict("records")
        out = pipeline.build_hf_dataset(
            rows, target_size=args.target_size, relation_fraction=args.relation_fraction
        )
        pd.DataFrame(out).to_csv(args.out, index=False)
        print(f"wrote {len(out)} rows -> {args.out}")
    elif args.cmd == "validate":
        rows = pd.read_csv(args.csv).to_dict("records")
        checker = lambda q, opts, img: call_openai_vision(q, opts, img, model=args.model)
        kept = pipeline.cross_validate(rows, checker, attempts=args.attempts)
        pd.DataFrame(kept).to_csv(args.out, index=False)
        print(f"kept {len(kept)}/{len(rows)} -> {args.out}")
    elif args.cmd == "splits":
        rows = pd.read_csv(args.csv).to_dict("records")
        easy, hard = pipeline.easy_hard_splits(rows)
        pd.DataFrame(easy).to_csv(f"{args.out_prefix}_easy.csv", index=False)
        pd.DataFrame(hard).to_csv(f"{args.out_prefix}_hard.csv", index=False)
        print(f"easy={len(easy)} hard={len(hard)}")
    elif args.cmd == "stats":
        rows = pd.read_csv(args.csv).to_dict("records")
        stats, last = pipeline.compute_data_stats(rows)
        print(json.dumps(stats, indent=2))
        print(last)


if __name__ == "__main__":
    main()
