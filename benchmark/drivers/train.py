"""Training: groups of K same-bucket batches through the Trainer's
multistep train step, one CUDA graph replay a group.

Set-up collates the mix's batches onto the device with the program's data
layer, builds the train state from the harness's weights
(``create_train_state``) and its step (``make_multistep_train_step``),
and runs one group of K on each bucket, which captures its graph.  The
first two of these groups, on the first bucket of the schedule and on
the largest bucket, are the check's: forward hooks on the model and its
mask heads are in place while their graphs are captured, so that each
replay of those graphs, the window's too, copies out every step's logits
and sampled node masks.  The window runs the groups in the mix's fixed
bucket schedule, each bucket's batches in turn, and reads each group's
metrics back once, as the Trainer does.

The check, once the window has closed: the reference rebuilds the two
groups' batches from the raw data and takes the same 2K steps at f32 from
the same weights, with the dropout masks and the sampler's noise drawn
from generators seeded by the step as the program seeds them
(``seed * 1000003 + step``).  The sampled node masks are discrete: where
rounding moves a score across the top-k cut the two sides train on other
nodes.  So, as the inference check puts the returned masks in the
reference's place, the reference here takes the node masks that the
program's 2K steps sampled as its own mask's values, keeping its own
sampler's gradient.
A question's logit error is its widest against the reference, in units
of that question's own rounding error at bf16 (the reference run again
with every product's operands rounded to bf16).  ``logit_gap_steps``:
the mean over the 2K steps of each step's widest question error, which
an answer altered where it is produced moves; ``logit_gap_p99``: the
99th percentile of the errors of all the steps' questions, which a lower
precision moves.  The widest error of all (``logit_gap``) swings from run
to run on sound runs and is read beside them.  ``loss_gap``: how far each step's reported loss
lies from the mean cross-entropy of its own logits over every row of the
batch, relative, the widest of the 2K.  ``change_gap``: of each
parameter's change after the two groups, the gap between the program's
norm and the reference's over the larger of the reference's norm and the
median leaf's, at the worst leaf, over the leaves whose reference
gradient is not below a thousandth of the median leaf's.  Adam's first
moment after the two groups (``moment_gap``, the same measure) is read
beside them (``PERF.md``).
"""

from __future__ import annotations

import statistics

import torch

from benchmark import gqa_gen
from benchmark.fixture import Fixture
from benchmark.harness import clock, port_config, setup_phase, subseed
from benchmark.reference import model as ref
from benchmark.weights import make_weights
from benchmark.yardstick import forward_flops, real_forward_flops

KEYS = ("loss_sum", "correct", "count", "grad_norm")


def step_seed(cfg_seed: int, step: int) -> int:
    return (cfg_seed * 1_000_003 + step) % (2 ** 63)


def reference_steps(fx, cfgd, cfg_seed, plan, weights, device,
                    prec=ref.identity, lr=1e-6, kept=1.0, masks=None,
                    scaled=None, altered=False) -> dict:
    """Reference steps on the batches of ``plan`` (``(bucket, composition)``
    a step, in order): their ``loss``, ``logits`` and node ``masks``, each
    leaf's Adam first ``moment``, mean gradient norm (``grad``) and
    ``change`` after the last.  ``masks`` (one ``[B, N]`` a step) are taken
    as the sampled node masks' values.  Faults for the check to catch:
    ``kept`` below 1 leaves the other rows of each batch out of the loss;
    ``scaled`` (``(prefix, factor)``) scales those leaves' gradients;
    ``altered`` puts each step's first answer last in the logits it
    returns."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = [n for n in weights if not n.endswith(("running_mean",
                                                   "running_var"))]
    P = dict(weights)
    start = {n: weights[n].clone() for n in names}
    for n in names:
        P[n] = weights[n].clone().requires_grad_(True)
    opt = ref.Adam({n: P[n] for n in names}, lr)
    out = {"loss": [], "masks": [], "logits": [], "labels": []}
    grad = {n: 0.0 for n in names}
    for step, (key, j) in enumerate(plan):
        B = fx.reference_batch(key, j, device)
        gen = torch.Generator(device=device).manual_seed(
            step_seed(cfg_seed, step))
        fw = ref.forward(P, B, cfgd, train=True, gen=gen, prec=prec,
                         mask=None if masks is None else masks[step])
        rows = torch.ones_like(B["labels"], dtype=torch.float32)
        rows[int(kept * len(rows)):] = 0.0
        loss = ref.loss_fn(fw["logits"], B["labels"], rows)
        grads = torch.autograd.grad(loss, [P[n] for n in names],
                                    allow_unused=True)
        grads = {n: (g if g is not None else torch.zeros_like(P[n]))
                 for n, g in zip(names, grads)}
        if scaled is not None:
            grads = {n: g * scaled[1] if n.startswith(scaled[0]) else g
                     for n, g in grads.items()}
        for n, g in grads.items():
            grad[n] += float(g.norm()) / len(plan)
        opt.step({n: P[n] for n in names}, grads)
        out["loss"].append(float(loss.detach()))
        out["masks"].append(fw["mask"].detach() > 0.5)
        logits = fw["logits"].detach()
        if altered:
            logits = logits.clone()
            logits[0, logits[0].argmax()] = logits[0].min() - 1.0
        out["logits"].append(logits)
        out["labels"].append(B["labels"])
    out["grad"] = grad
    out["moment"] = {n: float(opt.m[n].norm()) for n in names}
    out["change"] = {n: float((P[n].detach() - start[n]).norm())
                     for n in names}
    return out


def leaf_gaps(prog: dict, refn: dict, names) -> list:
    """``|prog - ref| / max(ref, median ref)`` of each leaf in ``names``."""
    med = statistics.median(refn.values())
    return [abs(prog[n] - refn[n]) / max(refn[n], med, 1e-30) for n in names]


LOGIT_FLOOR = 1e-4


def compare(subject: dict, got: dict, low: dict) -> dict:
    """The numbers of ``subject``'s steps (the program's, or a control's)
    against ``got`` and ``low``, the reference's at f32 and with bf16
    products, both on the subject's node masks: those compared, then the
    ones read beside them."""
    errs = []
    loss = 0.0
    for s_lg, r_lg, l_lg, labels, reported in zip(
            subject["logits"], got["logits"], low["logits"], got["labels"],
            subject["loss"]):
        unit = torch.clamp((l_lg - r_lg).abs().amax(1), min=LOGIT_FLOOR)
        errs.append((s_lg.float() - r_lg).abs().amax(1) / unit)
        own = float(ref.loss_fn(s_lg.float(), labels,
                                torch.ones_like(labels, dtype=torch.float32)))
        loss = max(loss, abs(reported - own) / abs(own))
    widest = torch.stack([e.max() for e in errs]).double()
    errs = torch.cat(errs).double()
    med = statistics.median(got["grad"].values())
    moved = [n for n, g in got["grad"].items() if g >= 1e-3 * med]
    change = leaf_gaps(subject["change"], got["change"], moved)
    moment = leaf_gaps(subject["moment"], got["moment"], moved)
    return {"logit_gap_steps": float(widest.mean()),
            "logit_gap_p99": float(torch.quantile(errs, 0.99)),
            "loss_gap": loss, "change_gap": max(change),
            "logit_gap": float(errs.max()),
            "logit_gap_mean": float(errs.mean()),
            "moment_gap": max(moment),
            "loss_gap_reference": max(abs(a - b) / abs(b) for a, b in zip(
                subject["loss"], got["loss"])),
            "change_gap_median": statistics.median(change),
            "moment_gap_median": statistics.median(moment)}


class Driver:
    def __init__(self, cell, seed, device, tracer):
        self.cell, self.seed, self.dev, self.tracer = cell, seed, device, tracer
        self.mix = cell.mix

    def setup(self):
        from isubgvqa_tpu_torch.train import (create_train_state,
                                              make_multistep_train_step)

        mix, dev = self.mix, self.dev
        self.cfg = port_config(self.cell.config, mix, self.seed)
        self.B, self.K = mix["batch_size"], mix["group"]
        self.fx = Fixture(self.cell, self.seed, self.B,
                          mix["batches_per_bucket"], mix["questions_per_bucket"])
        setup_phase("raw data")
        host = self.fx.program_batches(self.cfg, dev.type == "cuda")
        self.batches = {k: [b.to(dev) for b in v] for k, v in host.items()}
        del host
        setup_phase("program's batches")
        self.keys = self.fx.keys
        self.sched = gqa_gen.schedule(mix["shares"], 1 << 16)
        self.real = {k: [real_forward_flops(self.cell.config, s)
                         for s in self.fx.sizes[k]] for k in self.keys}
        self.padded = {k: [forward_flops(self.cell.config, *self._shape(b))
                           for b in self.batches[k]] for k in self.keys}
        weights = make_weights(self.cell.config, len(self.fx.itos),
                               subseed(self.seed, "weights"), dev)
        self.state = create_train_state(self.cfg, self.fx.vocab,
                                        mix["steps_per_epoch"], device=dev,
                                        state_dict=weights)
        self.step = make_multistep_train_step(self.state.model,
                                              self.state.optimizer, self.cfg)
        setup_phase("weights and train state")
        self.ptr = {k: 0 for k in self.keys}
        order = list(dict.fromkeys(self.keys[i] for i in self.sched[:1000]))
        # the check's groups: their graphs are captured with the copy-out
        # hooks in place
        self.checked = list(dict.fromkeys([order[0], max(self.keys)]))
        hooks = self._copy_out_hooks()
        rows, masks, logits = [], [], []
        for k in self.checked:
            self.state, m = self.step(self.state, self._group(k)[0])
            rows += self._read(m)
            # the group's K steps: on the card those of the capture, whose
            # warm-up step comes first; kept from the next replay
            masks += [t.clone() for t in self.taken[-self.K:]]
            logits += [t.clone() for t in self.taken_logits[-self.K:]]
            self.taken.clear()
            self.taken_logits.clear()
        for h in hooks:
            h.remove()
        opt = self.state.optimizer
        named = list(self.state.model.named_parameters())
        self.prog = {
            "loss": [r[0] / max(r[2], 1.0) for r in rows],
            "masks": masks, "logits": logits,
            "change": {n: float((p.detach() - weights[n]).norm())
                       for n, p in named},
            "moment": {n: float(opt.adam.state[p]["exp_avg"].norm())
                       for n, p in named}}
        del weights
        setup_phase("the check's groups")
        for k in order:
            if k not in self.checked:
                self.state, m = self.step(self.state, self._group(k)[0])
                self._read(m)
        setup_phase("a group a bucket")

    def _copy_out_hooks(self) -> list:
        """Forward hooks on the model (its logits) and on the masked
        layers' mask heads (the sampled node masks) that keep a copy of
        each output."""
        self.taken, self.taken_logits = [], []

        def keep(mod, args, out):
            self.taken.append((out[..., 0] > 0.5).clone())

        def keep_logits(mod, args, out):
            self.taken_logits.append(out.logits.detach().clone())

        model = self.state.model
        return [model.register_forward_hook(keep_logits)] + [
            m.register_forward_hook(keep) for name, m in model.named_modules()
            if name.startswith("gat_seq.convs.") and name.endswith(".mask")]

    @staticmethod
    def _shape(batch):
        b, n = batch.node_tokens.shape[:2]
        return b, n, batch.edge_src.shape[1], batch.qst_tokens.shape[1]

    @staticmethod
    def _read(m) -> list:
        return torch.stack([m[k].float() for k in KEYS], 1).tolist()

    def _group(self, key) -> list:
        ring = self.batches[key]
        j = self.ptr[key]
        self.ptr[key] = (j + self.K) % len(ring)
        return [ring[(j + i) % len(ring)] for i in range(self.K)], j

    def window(self, seconds: float) -> dict:
        tr = self.tracer
        t_start = clock()
        deadline = t_start + seconds
        groups = questions = 0
        real = padded = host_call = 0.0
        g = 0
        while True:
            tr.tick(clock() - t_start)
            key = self.keys[self.sched[g]]
            batches, j = self._group(key)
            t0 = clock()
            with tr.phase("group_call"):
                self.state, m = self.step(self.state, batches)
            t1 = clock()
            with tr.phase("metric_read"):
                self._read(m)
            t2 = clock()
            host_call += t1 - t0
            groups += 1
            questions += self.K * self.B
            ring = len(self.batches[key])
            for i in range(self.K):
                real += self.real[key][(j + i) % ring]
                padded += self.padded[key][(j + i) % ring]
            g += 1
            if t2 >= deadline:
                break
        return {"window_s": t2 - t_start, "groups": groups,
                "questions": questions, "host_group_s": host_call,
                "real_flops": real, "padded_flops": padded,
                "attempted": groups * self.K, "failed": 0}

    def end_to_end(self, c: dict) -> dict:
        return {"train_qps": c["questions"] / c["window_s"]}

    def free(self):
        del self.state, self.step, self.batches
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def plan(self) -> list:
        """The check's steps: ``(bucket, composition)`` each, in order."""
        return [(k, j) for k in self.checked for j in range(self.K)]

    def reference(self, prec=ref.identity, masks=None, **fault) -> dict:
        weights = make_weights(self.cell.config, len(self.fx.itos),
                               subseed(self.seed, "weights"), self.dev)
        return reference_steps(self.fx, self.cell.config, self.cfg.seed,
                               self.plan(), weights, self.dev, prec,
                               lr=self.cfg.warmup_start_lr, masks=masks,
                               **fault)

    def judged(self, subject: dict) -> dict:
        """``subject``'s numbers against the reference on its masks."""
        m = subject["masks"]
        return compare(subject, self.reference(masks=m),
                       self.reference(ref.bf16, masks=m))

    def check(self):
        lim = self.cell.limits()
        got = self.judged(self.prog)
        self.readings = got
        return [(n, got[n], lim[n]) for n in lim]


def control(driver) -> dict:
    """The numbers of the reference in the program's place at float8."""
    return driver.judged(driver.reference(ref.fp8))


FAULTS = {"half_batch": {"kept": 0.5}, "altered_answer": {"altered": True}}


def faults(driver, names=tuple(FAULTS)) -> dict:
    """The numbers of the reference, in the program's place, with half of
    each batch left out of the loss (the mean over the rest), and with one
    answer a step altered where it is produced: the check has to fail
    each."""
    return {n: driver.judged(driver.reference(**FAULTS[n])) for n in names}


def probes(driver) -> dict:
    """The numbers of the reference, in the program's place, with the
    second graph layer's gradients doubled: a fault that no compared
    number catches, read for ``PERF.md``."""
    return {"grad_doubled": driver.judged(driver.reference(
        scaled=("gat_seq.convs.1.", 2.0)))}


def details(driver) -> dict:
    """Every reading of the program's steps, and the leaves whose change
    and first moment lie farthest from the reference's (for calibration)."""
    got = driver.reference(masks=driver.prog["masks"])
    out = dict(driver.readings)
    for what in ("change", "moment"):
        names = list(got[what])
        gaps = leaf_gaps(driver.prog[what], got[what], names)
        worst = sorted(zip(gaps, names), reverse=True)[:6]
        out[what + "_worst_leaves"] = [[n, g] for g, n in worst]
    return out
