"""Batched serving engine with continuous batching (port of
`repro.serve.engine`).

Fixed decode batch of `slots`; finished slots are immediately refilled from
the request queue (single-request prefill into a fresh B=1 cache, then the
state tensors are written into the batched cache at that slot, in place).
Per-slot position vectors keep sequences independent: a decode step passes
every slot's position as a (B,) tensor, empty slots included (their output
is discarded), so attention writes the cache through its scatter branch.
It serves the decoder-only families: dense, MoE, SSM and hybrid.

Timed, multi-tenant serving: every `step()` ticks a discrete clock `t` (even
when no slot is live), and a request becomes eligible once `t >= submit_at`.
The admission `policy` is "fifo" (submit_at, submission order), "priority"
(tenant priority first) or "preempt" (a waiting request may evict the
most-recently-admitted active preemptible (interactive=False) request of
strictly lower priority; the victim keeps its tokens and re-prefills
prompt + generated on re-admission). `replay_trace` replays a
`core.traces.RequestTrace` on an engine.

The engine records the host time of each prefill and each decode step in
`prefill_s` / `decode_s`; both already end in a device-to-host copy of the
sampled tokens, so no extra synchronisation is added.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.runtime import Runtime
from repro_torch.serve.serve_step import sample_logits

ENGINE_POLICIES = ("fifo", "priority", "preempt")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (P,) int
    max_new_tokens: int = 32
    temperature: float = 0.0
    output: Optional[List[int]] = None
    # timed multi-tenant submission
    submit_at: int = 0              # step at which the request arrives
    priority: int = 0               # higher wins under priority/preempt
    interactive: bool = True        # False = preemptible offline/batch
    # bookkeeping recorded by the engine
    admit_step: int = -1            # step of FIRST admission
    finish_step: int = -1
    n_preemptions: int = 0
    seq: int = -1                   # submission order, set by submit()


def _splice(cache: Dict, cache1: Dict, slot: int):
    """Write a B=1 cache into batch slot `slot` of `cache`, leaf by leaf
    (leaves are (L, B, ...), possibly under sub-dicts: {"attn": {k, v, kv_pos}};
    the hybrid's {"ssm": {conv, ssd}, "attn": {k, v, kv_pos}})."""
    for k, small in cache1.items():
        if isinstance(small, dict):
            _splice(cache[k], small, slot)
        else:
            cache[k][:, slot:slot + 1] = small


class ServeEngine:
    def __init__(self, cfg: ModelConfig, rt: Runtime, model: M.Model,
                 slots: int = 4, max_len: int = 512,
                 eos_token: Optional[int] = None, policy: str = "fifo"):
        if cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(
                "engine supports decoder-only families; encdec/vlm use the "
                "prefill/decode steps directly")
        if policy not in ENGINE_POLICIES:
            raise ValueError(f"policy {policy!r} not in {ENGINE_POLICIES}")
        self.device = rt.torch_device()
        self.cfg, self.rt, self.model = cfg, rt, model
        self.slots, self.max_len = slots, max_len
        self.eos = eos_token
        self.policy = policy
        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * slots
        self.pos = np.zeros(slots, np.int64)
        self.last_tok = np.zeros(slots, np.int64)
        self.cache = M.init_cache(cfg, rt, slots, max_len)
        self.gen = torch.Generator(self.device).manual_seed(0)
        self.t = 0                    # discrete step clock (idle steps tick)
        self.n_admits = 0             # every admission runs one prefill
        self._seq_ctr = 0
        self._slot_admit = [-1] * slots   # admission event index per slot
        self.prefill_s: List[float] = []
        self.decode_s: List[float] = []

    # -- internals ----------------------------------------------------------

    def _prefill_one(self, tokens: torch.Tensor):
        cache = M.init_cache(self.cfg, self.rt, 1, self.max_len)
        return self.model.prefill(tokens, cache)

    def _key(self, req: Request):
        if self.policy == "fifo":
            return (req.submit_at, req.seq)
        return (-req.priority, req.submit_at, req.seq)

    def _admit_into(self, slot: int, req: Request):
        """Prefill `req` into `slot`. Fresh admission prefills the prompt
        and samples the first token; a preempted request re-prefills
        prompt + generated-so-far and resumes without sampling (the next
        token comes from the next decode step)."""
        t0 = time.perf_counter()
        resumed = bool(req.output)
        if not resumed:
            req.output = []
            toks = np.asarray(req.prompt, np.int64)
        else:
            # the cache covers prompt + output[:-1]; output[-1] rides as last_tok
            toks = np.concatenate([np.asarray(req.prompt, np.int64),
                                   np.asarray(req.output[:-1], np.int64)])
        logits, cache1 = self._prefill_one(
            torch.as_tensor(toks, device=self.device)[None, :])
        _splice(self.cache, cache1, slot)
        if not resumed:
            first = int(sample_logits(logits, self.gen, req.temperature)[0])
            req.output.append(first)
            req.admit_step = self.t
        self.active[slot] = req
        self.pos[slot] = len(toks)
        self.last_tok[slot] = req.output[-1]
        self._slot_admit[slot] = self.n_admits
        self.n_admits += 1
        self.prefill_s.append(time.perf_counter() - t0)

    def _admit(self):
        elig = sorted((r for r in self.queue if r.submit_at <= self.t),
                      key=self._key)
        for req in list(elig):
            slot = next((s for s in range(self.slots)
                         if self.active[s] is None), None)
            if slot is None:
                break
            elig.remove(req)
            self.queue.remove(req)
            self._admit_into(slot, req)
        if self.policy != "preempt":
            return
        for req in elig:
            victims = [s for s in range(self.slots)
                       if self.active[s] is not None
                       and not self.active[s].interactive
                       and self.active[s].priority < req.priority]
            if not victims:
                continue
            slot = max(victims, key=lambda s: self._slot_admit[s])
            victim = self.active[slot]
            victim.n_preemptions += 1
            # victim keeps its progress and rejoins the queue; it is not
            # re-eligible until the next step (elig was snapshotted)
            self.queue.append(victim)
            self.queue.remove(req)
            self._admit_into(slot, req)

    # -- public -------------------------------------------------------------

    def submit(self, req: Request):
        if len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds engine "
                f"max_len ({self.max_len})")
        if req.submit_at < 0:
            raise ValueError(
                f"request {req.rid}: submit_at must be >= 0 "
                f"(got {req.submit_at})")
        req.seq = self._seq_ctr
        self._seq_ctr += 1
        self.queue.append(req)

    def step(self) -> int:
        """One clock tick: admissions, then — if any slot is live — one
        batched decode step. Idle ticks still advance the clock. Returns the
        number of live slots decoded."""
        self._admit()
        live = [s for s in range(self.slots) if self.active[s] is not None]
        if not live:
            self.t += 1
            return 0
        t0 = time.perf_counter()
        tokens = torch.as_tensor(self.last_tok, device=self.device)[:, None]
        pos = torch.as_tensor(self.pos, dtype=torch.int32, device=self.device)
        logits, self.cache = self.model.decode_step(tokens, self.cache, pos=pos)
        # per-slot temperatures: empty slots decode greedily (discarded),
        # live slots honor their request's setting on every decode step
        temps = np.zeros(self.slots, np.float32)
        for s in live:
            temps[s] = self.active[s].temperature
        nxt = sample_logits(logits, self.gen, torch.as_tensor(temps)).cpu().numpy()
        self.decode_s.append(time.perf_counter() - t0)
        for s in live:
            req = self.active[s]
            tok = int(nxt[s])
            req.output.append(tok)
            self.pos[s] += 1
            self.last_tok[s] = tok
            done = (len(req.output) >= req.max_new_tokens
                    or (self.eos is not None and tok == self.eos))
            if done:
                req.finish_step = self.t
                self.active[s] = None
                self._slot_admit[s] = -1
        self.t += 1
        return len(live)

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        for r in requests:
            self.submit(r)
        out: Dict[int, List[int]] = {}
        pending = {r.rid: r for r in requests}
        while pending:
            self.step()
            for rid, r in list(pending.items()):
                if r.output is not None and (
                        len(r.output) >= r.max_new_tokens
                        or (self.eos is not None and r.output
                            and r.output[-1] == self.eos)):
                    if all(r is not a for a in self.active):
                        out[rid] = r.output
                        del pending[rid]
        return out


def replay_trace(engine: ServeEngine, trace, *, rng=None) -> List[Request]:
    """Replay a `core.traces.RequestTrace` on a real engine: one `Request`
    per trace entry (synthetic prompts; arrival step -> `submit_at`, tenant
    -> priority/interactive, out length -> `max_new_tokens`), submitted in
    trace order and run to completion. Returns the requests with their
    engine-recorded `admit_step`/`finish_step`, which equal
    `trace_schedule(trace, engine.slots, engine.policy)`'s bit for bit.
    Requests decode greedily."""
    rng = np.random.default_rng(0) if rng is None else rng
    reqs = []
    for r in range(trace.n_requests):
        tc = trace.tenant_of(r)
        prompt = rng.integers(0, engine.cfg.vocab, trace.prompt_lens[r], dtype=np.int32)
        reqs.append(Request(
            rid=r, prompt=prompt, max_new_tokens=int(trace.out_lens[r]),
            submit_at=int(trace.arrival_steps[r]),
            priority=tc.priority, interactive=tc.interactive))
    engine.run(reqs)
    return reqs
