"""Batched inference: requests of one size bucket's batch each, in a
closed loop with a fixed number in flight.

A request is copied from pinned host memory to the device
(``GraphBatch.to``), runs the eval forward ``model(batch, generator=...,
noise=...)`` under ``torch.inference_mode()`` (the call that serving and
explanation make), and its answer ids (the argmax) and node masks come
back to pinned host memory.  The Gumbel noise of each request's sampler
is the harness's, drawn from the seed and the request's index, so the
reference sees the same.  Buckets follow the mix's fixed schedule; each
bucket's pairwise-distinct batches are used in turn.

The check, once the window has closed: for a sample of the window's
requests drawn from the seed (one a bucket), the reference rebuilds the
batch from the raw data and runs at f32 on the same weights and noise.
``mask_mismatch_pct``: the share of a request's questions whose returned
node mask differs from the reference's own (the Gumbel sampler's top k
of its relaxed k-hot values), the largest over the sampled requests:
rounding moves near-ties across the cut, so a sound run reads a few
percent.  ``answer_gap``: by how much the reference's logit of the
returned answer lies below the reference's best, with the returned node
mask put in the reference's place, in units of the question's own
rounding error at the configured bf16 (:func:`judge`), the widest over
the sampled questions.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from benchmark import gqa_gen
from benchmark.fixture import Fixture
from benchmark.harness import clock, port_config, setup_phase, subseed
from benchmark.reference import model as ref
from benchmark.weights import make_weights
from benchmark.yardstick import forward_flops, real_forward_flops

TINY = float(torch.finfo(torch.float32).tiny)


def gumbel(shape, gen, device):
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=TINY)))


@dataclasses.dataclass
class Request:
    index: int
    key: tuple
    batch: int
    t0: float
    event: object
    slot: int
    t_done: float = 0.0


LOGIT_FLOOR = 1e-4


def judge(fx, cfgd, key, j, noise_seed, weights, answers, masks, device,
          rows=256):
    """``(answer gaps [B], raw gaps [B], mask differs [B])`` of a
    request's returned answers and node masks against the f32 reference.
    A gap is in units of the question's own rounding error at bf16: the
    reference runs twice, at f32 and with every product's operands
    rounded to bf16, and the unit is the larger of the two runs' widest
    logit difference and a floor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = fx.reference_batch(key, j, device)
    b, n = B["node_mask"].shape
    g = torch.Generator(device=device).manual_seed(noise_seed)
    noise = gumbel((b, n), g, device)
    answers = torch.as_tensor(answers, device=device)
    masks = torch.as_tensor(masks, device=device)
    gaps, raw, differ = [], [], []
    with torch.no_grad():
        for s in range(0, b, rows):
            part = {k: v[s:s + rows] for k, v in B.items()}
            args = dict(noise=noise[s:s + rows], mask=masks[s:s + rows])
            out = ref.forward(weights, part, cfgd, **args)
            low = ref.forward(weights, part, cfgd, prec=ref.bf16, **args)
            differ.append(((masks[s:s + rows] != (out["own"] > 0.5))
                           & part["node_mask"]).any(1))
            lg = out["logits"]
            gap = lg.amax(1) - lg.gather(
                1, answers[s:s + rows, None].long())[:, 0]
            unit = torch.clamp((low["logits"] - lg).abs().amax(1),
                               min=LOGIT_FLOOR)
            gaps.append(gap / unit)
            raw.append(gap)
    return tuple(torch.cat(x).cpu().numpy() for x in (gaps, raw, differ))


class Driver:
    def __init__(self, cell, seed, device, tracer):
        self.cell, self.seed, self.dev, self.tracer = cell, seed, device, tracer
        self.mix = cell.mix

    # ------------------------------------------------------------ set-up
    def setup(self):
        from isubgvqa_tpu_torch.models.build import build_model

        mix, dev = self.mix, self.dev
        self.cfg = port_config(self.cell.config, mix, self.seed)
        self.B = mix["batch_size"]
        self.fx = Fixture(self.cell, self.seed, self.B,
                          mix["batches_per_bucket"], mix["questions_per_bucket"])
        setup_phase("raw data")
        self.host = self.fx.program_batches(self.cfg, dev.type == "cuda")
        setup_phase("program's batches")
        weights = make_weights(self.cell.config, len(self.fx.itos),
                               subseed(self.seed, "weights"), dev,
                               served_dtype=torch.bfloat16)
        self.model = build_model(self.cfg, self.fx.vocab, dev,
                                 state_dict=weights)
        del weights
        setup_phase("weights and model")
        self.gen = torch.Generator(device=dev).manual_seed(
            subseed(self.seed, "model"))
        self.noise_gen = torch.Generator(device=dev)
        self.keys = self.fx.keys
        self.sched = gqa_gen.schedule(mix["shares"], 1 << 17)
        self.ptr = {k: 0 for k in self.keys}
        n_max = max(k[0] for k in self.keys)
        pin = dev.type == "cuda"
        depth = mix["in_flight"]
        self.slots = [(torch.empty(self.B, dtype=torch.int32, pin_memory=pin),
                       torch.empty(self.B * n_max, dtype=torch.bool,
                                   pin_memory=pin))
                      for _ in range(depth + 1)]
        self.padded = {k: forward_flops(self.cell.config,
                                        *self._shape(self.host[k][0]))
                       for k in self.keys}
        self.real = {k: [real_forward_flops(self.cell.config, s)
                         for s in self.fx.sizes[k]] for k in self.keys}
        self.host_forward = 0.0
        self.hooks = self.tracer.hook_modules(
            self.model, ["scene_graph_encoder", "gat_seq",
                         "question_encoder", "program_decoder"])
        # warm every bucket's shape on the full path, twice
        setup_phase("counts")
        for key in self.keys:
            for _ in range(2):
                self._complete(self._dispatch(-1, key))
        setup_phase("warm-up")
        self.outputs = {}
        self.requests = {}

    @staticmethod
    def _shape(batch):
        b, n = batch.node_tokens.shape[:2]
        return b, n, batch.edge_src.shape[1], batch.qst_tokens.shape[1]

    def noise_seed(self, r: int) -> int:
        return subseed(self.seed, f"noise{r}")

    # ------------------------------------------------------------ requests
    def _dispatch(self, r: int, key=None) -> Request:
        tr = self.tracer
        key = key or self.keys[self.sched[r]]
        j = self.ptr[key]
        self.ptr[key] = (j + 1) % len(self.host[key])
        hb = self.host[key][j]
        b, n = hb.node_mask.shape
        t0 = clock()
        with tr.phase("copy_in"):
            batch = hb.to(self.dev, non_blocking=True)
            self.noise_gen.manual_seed(self.noise_seed(r))
            noise = gumbel((b, n), self.noise_gen, self.dev)
        tr.tag = str(r)
        tf = clock()
        with tr.phase("forward"), torch.inference_mode():
            out = self.model(batch, generator=self.gen, noise=noise)
        self.host_forward += clock() - tf
        slot = r % len(self.slots)
        ans, msk = self.slots[slot]
        with tr.phase("output_copy"), torch.inference_mode():
            ans.copy_(out.logits.argmax(-1).to(torch.int32),
                      non_blocking=True)
            msk[:b * n].view(b, n).copy_(out.node_mask[..., 0] > 0.5,
                                         non_blocking=True)
            ev = torch.cuda.Event() if self.dev.type == "cuda" else None
            if ev is not None:
                ev.record()
        return Request(r, key, j, t0, ev, slot)

    def _complete(self, req: Request) -> float:
        with self.tracer.phase("wait"):
            if req.event is not None:
                req.event.synchronize()
        t = clock()
        req.t_done = t
        if req.index >= 0:
            with self.tracer.phase("collect"):
                ans, msk = self.slots[req.slot]
                b, n = self.host[req.key][req.batch].node_mask.shape
                self.outputs[req.index] = (ans.numpy().copy(),
                                           msk[:b * n].numpy().reshape(b, n)
                                           .copy())
        return t

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        depth = self.mix["in_flight"]
        self.host_forward = 0.0
        inflight = collections.deque()
        done = []
        t_start = clock()
        deadline = t_start + seconds
        r = 0
        while True:
            self.tracer.tick(clock() - t_start)
            if len(inflight) == depth:
                req = inflight.popleft()
                t = self._complete(req)
                done.append(req)
                if t >= deadline:
                    break
            req = self._dispatch(r)
            self.requests[r] = req
            inflight.append(req)
            r += 1
        t_end = done[-1].t_done
        host_fwd = self.host_forward
        for req in inflight:
            self._complete(req)
        self.done = done
        lat = [q.t_done - q.t0 for q in done]
        real = sum(self.real[q.key][q.batch] for q in done)
        padded = sum(self.padded[q.key] for q in done)
        return {"window_s": t_end - t_start, "requests": len(done),
                "questions": len(done) * self.B, "latencies": lat,
                "host_forward_s": host_fwd, "dispatched": r,
                "real_flops": real, "padded_flops": padded,
                "attempted": len(done), "failed": 0}

    def end_to_end(self, c: dict) -> dict:
        return {"infer_qps": c["questions"] / c["window_s"],
                "infer_request_ms_p95": float(np.percentile(
                    np.asarray(c["latencies"]) * 1e3, 95))}

    # ------------------------------------------------------------ check
    def free(self):
        for h in self.hooks:
            h.remove()
        del self.model, self.host
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """One completed request a bucket, drawn from the seed."""
        rng = np.random.default_rng(subseed(self.seed, "sample"))
        by_key = collections.defaultdict(list)
        for q in self.done:
            by_key[q.key].append(q)
        return [by_key[k][int(rng.integers(0, len(by_key[k])))]
                for k in self.keys if by_key[k]]

    def check(self, judge_fn=None):
        lim = self.cell.limits()
        weights = make_weights(self.cell.config, len(self.fx.itos),
                               subseed(self.seed, "weights"), self.dev,
                               served_dtype=torch.bfloat16)
        mismatch, gaps, self.spread = [], [], []
        for q in self.sample():
            ans, msk = self.outputs[q.index]
            g, raw, d = judge(self.fx, self.cell.config, q.key, q.batch,
                              self.noise_seed(q.index), weights, ans, msk,
                              self.dev)
            mismatch.append(100.0 * float(d.mean()))
            gaps.append(float(g.max()))
            self.spread.append(spread(q.key, g, raw, d))
        return [("mask_mismatch_pct", max(mismatch),
                 lim["mask_mismatch_pct"]),
                ("answer_gap", max(gaps), lim["answer_gap"])]


def spread(key, g, raw, differ) -> dict:
    """Quantiles of a request's gaps (for calibration)."""
    qs = (50, 99, 99.9, 100)
    return {"key": list(key),
            "gap": [float(np.percentile(g, p)) for p in qs],
            "raw_gap": [float(np.percentile(raw, p)) for p in qs],
            "mismatch_pct": 100.0 * float(differ.mean())}


def control(driver) -> dict:
    """The check's numbers of the reference in the program's place at
    float8 (its own node masks and answers), on the window's sample."""
    fx, cfgd, dev = driver.fx, driver.cell.config, driver.dev
    weights = make_weights(cfgd, len(fx.itos), subseed(driver.seed, "weights"),
                           dev, served_dtype=torch.bfloat16)
    mismatch, gaps, spreads = [], [], []
    for q in driver.sample():
        B = fx.reference_batch(q.key, q.batch, dev)
        b, n = B["node_mask"].shape
        g = torch.Generator(device=dev).manual_seed(driver.noise_seed(q.index))
        noise = gumbel((b, n), g, dev)
        ans, msk = [], []
        with torch.no_grad():
            for s in range(0, b, 256):
                part = {k: v[s:s + 256] for k, v in B.items()}
                out = ref.forward(weights, part, cfgd, noise=noise[s:s + 256],
                                  prec=ref.fp8)
                ans.append(out["logits"].argmax(-1))
                msk.append(out["mask"] > 0.5)
        gp, raw, d = judge(fx, cfgd, q.key, q.batch,
                           driver.noise_seed(q.index), weights,
                           torch.cat(ans), torch.cat(msk), dev)
        mismatch.append(100.0 * float(d.mean()))
        gaps.append(float(gp.max()))
        spreads.append(spread(q.key, gp, raw, d))
    return {"mask_mismatch_pct": max(mismatch), "answer_gap": max(gaps),
            "spread": spreads}
