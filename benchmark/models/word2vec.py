"""Word2vec through ``Word2Vec.train``.

Set-up builds one ``Word2Vec`` from the seed's corpus and vocabulary,
writes the benchmark's initial table into it and drives it through its
checked steps: one ``train`` call of one step (the accumulators after it
give the first gradient), then one call of ``CHECK_GROUPS`` groups of
the window's group length through the window's own feed and pipeline.
The first group of that call is the graph's warm-up and capture, the
rest are replays of the very graph the window replays, so the checked
steps also warm up every shape the window uses.  The window is one
``train`` call over whole groups until ``--seconds`` have passed.  A
traced run adds, before the window, one call of ``PROFILE_GROUPS``
groups under ``torch.profiler`` (its steady window starts at group
``PROFILE_SKIP``) and, after it, one call of ``COUNT_GROUPS`` groups
with the transfer's ledger armed.  Once the window has closed, the
peak memory is read and the program is freed, the reference follows
the checked steps, and the input stage's check looks for the rows of
``LOCATED`` of the checked batches in the corpus."""

from __future__ import annotations

import copy
import gc
import importlib
import json
import sys
from typing import Optional

import numpy as np
import torch

from benchmark import trace, traffic, weights
from benchmark.reference import batches as ref_batches
from benchmark.reference import check, w2v as ref
from benchmark.roofline import w2v_step

CHECK_GROUPS = 3
PROFILE_GROUPS = 32
PROFILE_SKIP = 4
COUNT_GROUPS = 4
LOCATED = 3
VARIANTS = ("program", "tf32", "bf16", "half_batch", "token")


def model_seed(seed: int) -> int:
    return traffic.sub_seed(seed, 4)


def build_model(cfg: dict, mix: dict, vocab, seed: int, device):
    from swiftmpi_tpu_torch.models.word2vec import Word2Vec
    from swiftmpi_tpu_torch.utils import ConfigParser
    conf = ConfigParser().update({
        "cluster": {"transfer": mix["transfer"],
                    "server_num": mix["server_num"]},
        "word2vec": {k: cfg[k] for k in ("len_vec", "window", "negative",
                                         "sample", "learning_rate", "sg")},
        "server": {"initial_learning_rate": cfg["server_learning_rate"],
                   "dtype": cfg["dtype"]},
        "worker": {"minibatch": cfg["minibatch"],
                   "inner_steps": mix["inner_steps"],
                   "pipeline": mix["pipeline"]}})
    return Word2Vec(config=conf, device=device,
                    seed=model_seed(seed)).build_from_vocab(vocab)


def table_module(mix: dict):
    """``benchmark/tables/<transfer>.py``."""
    return importlib.import_module(f"benchmark.tables.{mix['transfer']}")


class Program:
    """A cell's program, set up from the seed, with what its checked
    steps left (``prog``)."""

    def __init__(self, cell, seed: int, device, part):
        from swiftmpi_tpu_torch.data import native
        from swiftmpi_tpu_torch.data.text import Vocab
        self.cell, self.seed = cell, int(seed)
        self.cfg, self.mix = cell.config, cell.traffic
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.B = int(self.mix["batch_centers"])
        self.group = int(self.mix["inner_steps"])
        self.table = table_module(self.mix)
        self.part = part
        with part("corpus_s"):
            (self.tokens, self.offsets, keys,
             self.counts) = traffic.make_corpus(self.cfg, seed)
        with part("vocab_s"):
            vocab = Vocab(keys, self.counts)
        self.V, self.d = len(vocab), int(self.cfg["len_vec"])
        with part("kernels_s"):
            if not native.available():
                raise RuntimeError("the native batcher does not build")
            if self.cuda:
                from swiftmpi_tpu_torch.kernels import build
                build.build_all()
        with part("model_s"):
            self.model = build_model(self.cfg, self.mix, vocab, seed,
                                     self.dev)
        with part("weights_s"):
            slots = self.table.slots(self.model, vocab.keys)
            if bool((slots < 0).any()):
                raise RuntimeError("a vocabulary word has no slot")
            weights.hand_to_program(self.table, self.model, slots, seed,
                                    self.V, self.d)
            self.capacity = self.table.capacity(self.model)
            self.inv = torch.full((self.capacity,), -1, dtype=torch.int64,
                                  device=self.dev)
            self.inv[slots] = torch.arange(self.V, device=self.dev)
        self.feed = traffic.feed(self.tokens, self.offsets, vocab,
                                 self.cfg, self.mix, seed)
        self.steps = 0
        self.calls = []
        self.checked = []
        self.prog = None
        self._prof_batches = []
        self._steps_before_profile = 0
        self._rmodels = {}

    def train(self, batches) -> list:
        losses = self.model.train(batcher=batches, niters=1,
                                  batch_size=self.B)
        self.steps += self.model.train_metrics["steps"]
        return losses

    def _grab(self, fields) -> tuple:
        """``(field -> (vocabulary indices, rows on the host), stray)``:
        the rows whose accumulator is not zero, and how many of those
        hold no vocabulary word."""
        out, stray = {}, 0
        for f in fields:
            slots = self.table.touched(self.model, f"{f[0]}2sum")
            idx = self.inv[slots]
            stray += int((idx < 0).sum())
            keep = idx >= 0
            out[f[0]] = (idx[keep].cpu(), self.table.read_rows(
                self.model, f, slots[keep]))
        return out, stray

    def checked_steps(self) -> None:
        prog = {"losses": []}
        with self.part("checked_steps_s"):
            prog["losses"] += self.train(self.feed.take(1, self.checked))
            prog["acc1"], _ = self._grab(("h2sum", "v2sum"))
            n = CHECK_GROUPS * self.group
            prog["losses"] += self.train(self.feed.take(n, self.checked))
            self.calls = [1, n]
            prog["final"], prog["stray"] = self._grab(("h", "v"))
        self.prog = prog

    def profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._steps_before_profile = self.steps
        with torch.profiler.profile(activities=acts) as prof:
            self.train(self.feed.take(PROFILE_GROUPS * self.group,
                                      self._prof_batches))
        return prof

    def window(self, seconds: float) -> dict:
        batches = self.feed.until(seconds)
        self.train(batches)
        m = dict(self.model.train_metrics)
        self._window_words_gap = float(abs(m["words"] - batches.words))
        print(json.dumps({"window_words_by_second": by_second(
            batches.group_times, self.group * self.B)}), file=sys.stderr)
        return {"attempted": int(m["steps"]),
                "values": {"words_per_s": m["words"] / m["seconds"]},
                "ctx": {"train": m}}

    def count(self, ctx: dict) -> None:
        t = self.model.transfer
        t.count_traffic = True
        since = t.traffic()
        counted = self.feed.take(COUNT_GROUPS * self.group)
        self.train(counted)
        ctx["traffic"] = {"delta": t.traffic_delta(since),
                          "words": counted.words}

    def release(self) -> None:
        self.feed.close()
        self.model = self.feed = None
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    # -- the reference -------------------------------------------------------
    def init_rows(self, field: str, idx: torch.Tensor) -> torch.Tensor:
        return weights.rows(self.seed, field, self.V, self.d,
                            idx.to(self.dev))

    def ref_model(self, tf32: bool = False) -> ref.Model:
        if tf32 not in self._rmodels:
            self._rmodels[tf32] = ref.Model(self.cfg, self.counts, self.dev,
                                            tf32=tf32)
        return self._rmodels[tf32]

    def reference(self, tf32: bool = False, keep_half: bool = False
                  ) -> dict:
        """The reference over the checked batches (``tf32``: its products
        in TF32, the control; ``keep_half``: the first half of each
        batch's centers only, a fault)."""
        rmodel = self.ref_model(tf32)
        draws = ref.Draws(model_seed(self.seed), self.V,
                          ref.draw_shape(self.cfg, self.B), self.dev)
        tb = [tuple(torch.as_tensor(a, device=self.dev) for a in b)
              for b in self.checked]
        tb = [(c.long(), x.long(), m) for c, x, m in tb]
        negs = [rmodel.negatives(*draws.next()) for _ in tb]
        keep = None
        if keep_half:
            keep = torch.arange(self.B, device=self.dev) < self.B // 2
        return ref.run_steps(rmodel, tb, negs, self.init_rows, keep=keep,
                             calls=self.calls)

    def numbers(self, prog: Optional[dict] = None) -> dict:
        """The compared numbers of ``prog`` (default: the program's
        checked steps) against the float32 reference."""
        nums = check.numbers(prog or self.prog, self.reference(),
                             self.init_rows)
        nums["unlocated_rows"] = float(ref_batches.unlocated_rows(
            [self.checked[i] for i in self.located()], self.tokens,
            self.offsets, self.cfg["window"]))
        if hasattr(self, "_window_words_gap"):
            nums["window_words_gap"] = self._window_words_gap
        return nums

    def located(self) -> list:
        """The checked batches whose rows the input stage's check looks
        for in the corpus: the first, and ``LOCATED - 1`` more drawn
        from the seed (the walk takes about a third of a second a batch
        of 5,000 rows on the host)."""
        n = len(self.checked)
        rng = np.random.default_rng(traffic.sub_seed(self.seed, 5))
        more = rng.choice(np.arange(1, n), size=min(LOCATED - 1, n - 1),
                          replace=False)
        return [0] + sorted(int(i) for i in more)

    def trace_context(self, prof) -> dict:
        """The profiled call's steady window, and the model FLOPs and
        kernel bytes of its steps (their negatives drawn again)."""
        win = trace.reduce(trace.chrome_events(prof), PROFILE_SKIP)
        if win is None:
            return {"window": None}
        first = PROFILE_SKIP * self.group
        steps = win.launches * self.group
        rmodel = self.ref_model()
        draws = ref.Draws(model_seed(self.seed), self.V,
                          ref.draw_shape(self.cfg, self.B), self.dev)
        draws.skip(self._steps_before_profile + first)
        sg = bool(int(self.cfg["sg"]))
        flops, nbytes = 0, {"gather": 0, "adagrad": 0}
        for b in self._prof_batches[first:first + steps]:
            c, x, mk = (torch.as_tensor(a, device=self.dev) for a in b)
            negs = rmodel.negatives(*draws.next())
            c, x = c.long(), x.long()
            flops += w2v_step.flops(sg, self.d, c, x, mk, negs)
            for k, v in w2v_step.launch_bytes(sg, self.d, self.capacity, c,
                                              x, mk, negs).items():
                nbytes[k] += v
        return {"window": win, "steps": steps, "flops": flops,
                "bytes": nbytes}


def by_second(times, words_a_group: int) -> list:
    """The words of the groups handed out in each whole second since the
    first: the window's timeline, to tell a slow start, a stall and a
    slower host apart (standard error only; no metric reads it)."""
    if not times:
        return []
    t0 = times[0]
    out = [0] * (int(times[-1] - t0) + 1)
    for t in times:
        out[int(t - t0)] += words_a_group
    return out


def as_program(refr: dict) -> dict:
    """A reference run's result in the form of the program's checked
    state, to stand in the program's place."""
    rows = refr["rows"].cpu()
    return {"losses": refr["losses"], "stray": 0,
            "acc1": {f: (rows, refr["acc1"][f].cpu()) for f in check.LEAVES},
            "final": {f: (rows, refr["final"][f].cpu())
                      for f in check.LEAVES}}


def _no_timing(name):
    class _Part:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    return _Part()


def readings(cell, seed: int, variants, device: str = "cuda") -> dict:
    """For one seed, the compared numbers of the program's checked steps
    (the lower readings), of the controls and of the planted faults (the
    upper readings):

    * ``program``: the program as the configuration states it;
    * ``tf32``: the reference with its float32 products in TF32, in the
      program's place (the precision below float32 with TF32 off);
    * ``bf16``: the program's own lower-precision path, ``[server] dtype:
      bfloat16`` tables;
    * ``half_batch``: the reference with the second half of each batch's
      centers left out, the means over the rest, in the program's place;
    * ``token``: one center of the first checked batch altered where the
      batcher produced it (the input stage's check).

    A state left unchanged reads 1 on both norm gaps by their definition
    and needs no run."""
    out = {}
    run = Program(cell, seed, device, _no_timing)
    run.checked_steps()
    run.release()
    if "program" in variants:
        out["program"] = run.numbers()
    if "tf32" in variants:
        out["tf32"] = run.numbers(as_program(run.reference(tf32=True)))
    if "half_batch" in variants:
        out["half_batch"] = run.numbers(as_program(run.reference(
            keep_half=True)))
    if "token" in variants:
        c, x, m = (a.copy() for a in run.checked[0])
        c[len(c) // 2] = (int(c[len(c) // 2]) + 1) % run.V
        out["token"] = {"unlocated_rows": float(ref_batches.unlocated_rows(
            [(c, x, m)], run.tokens, run.offsets, run.cfg["window"]))}
    if "bf16" in variants:
        low = copy.deepcopy(cell)
        low.config["dtype"] = "bfloat16"
        run16 = Program(low, seed, device, _no_timing)
        run16.checked_steps()
        run16.release()
        out["bf16"] = run16.numbers()
    return out
