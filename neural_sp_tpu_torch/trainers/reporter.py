"""Training history (counterpart of ``neural_sp_tpu/trainers/
reporter.py``): train and dev observations averaged per epoch into
``history.csv`` (the same columns as the JAX reporter's, sorted), which a
resumed run reads back, and a loss plot when matplotlib is installed.
"""
from __future__ import annotations

import csv
import os
from collections import defaultdict


class Reporter:
    def __init__(self, save_dir: str):
        self.save_dir = os.path.abspath(save_dir)
        os.makedirs(self.save_dir, exist_ok=True)
        self._obs_train: dict[str, list] = defaultdict(list)
        self._obs_dev: dict[str, list] = defaultdict(list)
        self._history: list[dict] = []
        self.step = 0
        self._csv_path = os.path.join(self.save_dir, "history.csv")
        if os.path.exists(self._csv_path):
            self.load()

    def add_observation(self, obs: dict, is_eval: bool = False):
        target = self._obs_dev if is_eval else self._obs_train
        for k, v in obs.items():
            try:
                target[k].append(float(v))
            except (TypeError, ValueError):
                pass

    def step_forward(self):
        self.step += 1

    def mean(self, key: str, is_eval: bool = False) -> float:
        vals = (self._obs_dev if is_eval else self._obs_train).get(key, [])
        return sum(vals) / len(vals) if vals else 0.0

    def epoch_summary(self, epoch: int, extra: dict | None = None) -> dict:
        row = {"epoch": epoch, "step": self.step}
        for k in self._obs_train:
            row[f"train_{k}"] = self.mean(k)
        for k in self._obs_dev:
            row[f"dev_{k}"] = self.mean(k, is_eval=True)
        row.update(extra or {})
        self._history.append(row)
        self._obs_train.clear()
        self._obs_dev.clear()
        self.save()
        return row

    def save(self):
        if not self._history:
            return
        keys = sorted({k for row in self._history for k in row})
        with open(self._csv_path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            for row in self._history:
                w.writerow(row)

    def load(self):
        with open(self._csv_path) as f:
            self._history = [dict(r) for r in csv.DictReader(f)]
        if self._history:
            self.step = int(float(self._history[-1].get("step", 0)))

    def snapshot(self):
        """Train and dev loss curves in ``loss.png``; nothing without
        matplotlib."""
        if not self._history:
            return
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        keys = [k for k in self._history[0]
                if k.startswith(("train_loss", "dev_loss"))]
        if not keys:
            return
        plt.figure(figsize=(8, 5))
        xs = [int(float(r["epoch"])) for r in self._history]
        for k in keys:
            plt.plot(xs, [float(r.get(k, "nan") or "nan")
                          for r in self._history], label=k)
        plt.xlabel("epoch")
        plt.legend()
        plt.savefig(os.path.join(self.save_dir, "loss.png"))
        plt.close()
