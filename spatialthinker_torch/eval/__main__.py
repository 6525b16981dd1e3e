"""CLI: ``python3 -m spatialthinker_torch.eval --dataset cv-bench --model <dir>
--provider torch|hf|openai|anthropic --template spatial_thinker ...`` -- the
arguments of ``spatialthinker_tpu/eval/__main__.py``, with ``torch`` (the
port's model and dense engine on the current CUDA device) in place of ``jax``.

``--model`` is a local HF checkpoint directory for ``torch`` (weights through
``load_params``, the tokenizer through ``transformers``), a model name for
the other providers."""

from __future__ import annotations

import argparse
from typing import List, Optional

PROVIDERS = ("torch", "hf", "openai", "anthropic")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="spatial benchmark evaluation")
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--model", default="Qwen/Qwen2.5-VL-3B-Instruct")
    parser.add_argument("--provider", default="torch", choices=PROVIDERS)
    parser.add_argument("--template", default="spatial_thinker")
    parser.add_argument("--num-samples", type=int, default=-1)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--max-new-tokens", type=int, default=2048)
    parser.add_argument("--output", default=None)
    parser.add_argument("--no-resume", action="store_true")
    return parser.parse_args(argv)


def build_provider(args: argparse.Namespace):
    if args.provider == "torch":
        import torch

        from ..models.qwen2_5_vl.params import default_device, load_params
        from ..trainer.main import load_tokenizer
        from .providers import TorchProvider

        model = load_params(args.model, device=default_device(), dtype=torch.bfloat16)
        tokenizer = load_tokenizer(args.model, model.cfg)
        return TorchProvider(model, model.cfg, tokenizer, max_new_tokens=args.max_new_tokens)
    if args.provider == "hf":
        from .providers import HFProvider

        return HFProvider(args.model, max_new_tokens=args.max_new_tokens)
    if args.provider == "openai":
        from .providers import OpenAIProvider

        return OpenAIProvider(args.model, max_tokens=args.max_new_tokens)
    from .providers import AnthropicProvider

    return AnthropicProvider(args.model, max_tokens=args.max_new_tokens)


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    from .harness import EvalConfig, run_evaluation

    output = args.output or f"eval_results/{args.dataset}_{args.provider}.json"
    summary = run_evaluation(
        build_provider(args),
        EvalConfig(
            dataset=args.dataset,
            template=args.template,
            num_samples=args.num_samples,
            batch_size=args.batch_size,
            output_file=output,
            resume=not args.no_resume,
        ),
    )
    print(summary)
    return summary


if __name__ == "__main__":
    main()
