"""Experiment tracking: fan-out logger over console / jsonl / wandb /
tensorboard / mlflow / swanlab backends (parity:
verl/utils/logger/logger.py:122-154) plus the validation generations table
(gen_logger.py AggregateGenerationsLogger). The port's own copy of
``spatialthinker_tpu/trainer/tracker.py``; the hosted backends are imported
only when named."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Tuple


class ConsoleBackend:
    def log(self, data: Dict[str, Any], step: int) -> None:
        parts = " ".join(f"{k}:{v:.4g}" if isinstance(v, float) else f"{k}:{v}" for k, v in sorted(data.items()))
        print(f"step {step} | {parts}", flush=True)

    def log_generations(self, samples, step: int) -> None:
        for inp, out, label, score in samples[:2]:
            print(f"[gen @{step}] score={score:.3f}\n  prompt: {inp[:200]}...\n  output: {out[:400]}")

    def finish(self) -> None:
        pass


class JsonlBackend:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.f = open(path, "a")

    def log(self, data: Dict[str, Any], step: int) -> None:
        self.f.write(json.dumps({"step": step, "time": time.time(), **data}) + "\n")
        self.f.flush()

    def log_generations(self, samples, step: int) -> None:
        pass

    def finish(self) -> None:
        self.f.close()


class WandbBackend:
    def __init__(self, project: str, name: str):
        import wandb

        self.wandb = wandb
        self.run = wandb.init(project=project, name=name)

    def log(self, data: Dict[str, Any], step: int) -> None:
        self.wandb.log(data, step=step)

    def log_generations(self, samples, step: int) -> None:
        table = self.wandb.Table(columns=["input", "output", "label", "score"], rows=list(samples))
        self.wandb.log({"val/generations": table}, step=step)

    def finish(self) -> None:
        self.wandb.finish()


class TensorboardBackend:
    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)

    def log(self, data: Dict[str, Any], step: int) -> None:
        for k, v in data.items():
            if isinstance(v, (int, float)):
                self.writer.add_scalar(k, v, step)

    def log_generations(self, samples, step: int) -> None:
        text = "\n\n".join(f"score={s}\n{o}" for _, o, _, s in samples[:4])
        self.writer.add_text("val/generations", text, step)

    def finish(self) -> None:
        self.writer.close()


class MlflowBackend:
    """Parity: reference utils/logger/logger.py MlflowLogger (:122-137)."""

    def __init__(self, project: str, name: str):
        import mlflow

        self.mlflow = mlflow
        mlflow.set_experiment(project)
        self.run = mlflow.start_run(run_name=name)

    def log(self, data: Dict[str, Any], step: int) -> None:
        metrics = {k.replace("/", "."): v for k, v in data.items()
                   if isinstance(v, (int, float))}
        self.mlflow.log_metrics(metrics, step=step)

    def log_generations(self, samples, step: int) -> None:
        text = "\n\n".join(f"score={s}\nprompt: {i}\n{o}" for i, o, _, s in samples[:8])
        self.mlflow.log_text(text, f"generations/step_{step}.txt")

    def finish(self) -> None:
        self.mlflow.end_run()


class SwanlabBackend:
    """Parity: reference utils/logger/logger.py SwanlabLogger (:140-154)."""

    def __init__(self, project: str, name: str):
        import swanlab

        self.swanlab = swanlab
        self.run = swanlab.init(project=project, experiment_name=name)

    def log(self, data: Dict[str, Any], step: int) -> None:
        self.swanlab.log(
            {k: v for k, v in data.items() if isinstance(v, (int, float))}, step=step
        )

    def log_generations(self, samples, step: int) -> None:
        rows = [
            self.swanlab.Text(f"score={s}\n{o}", caption=str(i)[:64])
            for i, o, _, s in samples[:8]
        ]
        if rows:
            self.swanlab.log({"val/generations": rows}, step=step)

    def finish(self) -> None:
        self.swanlab.finish()


class Tracker:
    def __init__(self, loggers: List[str], project: str, experiment: str, base_dir: str = "."):
        self.backends = []
        for name in loggers:
            if name == "console":
                self.backends.append(ConsoleBackend())
            elif name == "jsonl" or name == "file":
                self.backends.append(JsonlBackend(os.path.join(base_dir, f"{experiment}_metrics.jsonl")))
            elif name == "wandb":
                try:
                    self.backends.append(WandbBackend(project, experiment))
                except Exception as e:
                    print(f"[tracker] wandb unavailable ({e}); skipping")
            elif name == "tensorboard":
                try:
                    self.backends.append(TensorboardBackend(os.path.join(base_dir, "tb", experiment)))
                except Exception as e:
                    print(f"[tracker] tensorboard unavailable ({e}); skipping")
            elif name == "mlflow":
                try:
                    self.backends.append(MlflowBackend(project, experiment))
                except Exception as e:
                    print(f"[tracker] mlflow unavailable ({e}); skipping")
            elif name == "swanlab":
                try:
                    self.backends.append(SwanlabBackend(project, experiment))
                except Exception as e:
                    print(f"[tracker] swanlab unavailable ({e}); skipping")

    def log(self, data: Dict[str, Any], step: int) -> None:
        for b in self.backends:
            b.log(data, step)

    def log_generations(self, samples: List[Tuple[str, str, str, float]], step: int) -> None:
        for b in self.backends:
            b.log_generations(samples, step)

    def finish(self) -> None:
        for b in self.backends:
            b.finish()
