"""Continuous batching for autoregressive decode.

Counterpart of the JAX package's `serving/batcher.py`, with a bundle in
place of the JAX (model, variables) pair: many concurrent generation
streams share ONE slot-decode step per token tick.  Each request owns a
slot; slots sit at their OWN positions (`decode_step` with per-slot
`pos`, models/transformer.py), so requests admit and finish
independently — a new stream joins the running batch the tick after an
old one leaves.  `paged=True` swaps the per-slot [S, max_len, ...] cache
for shared page pools + a page table (vLLM-style paged KV): device
memory is pay-per-page, and each tick's attention runs the paged decode
kernel (B7, or B8 over int8 pools) on the card.

Host loop per tick: admit pending prompts into free slots (one prefill
forward per prompt bucket, through the flash-attention kernel on the
card), upload the tick's token / position / page-table vectors in ONE
packed transfer (`DeviceFeed.put_group`), one batched `decode_step` for
ALL slots, then one argmax read back and each live slot's token emitted
to its stream.  Greedy decode; every stream's tokens are `generate()`'s
for its prompt regardless of co-tenancy (tested).

The loop thread runs under `torch.inference_mode()` (a thread-local
mode, so the thread enters it itself) and owns the pools, the page
table and the free list; prefix registration and release reach it
through a control queue.

Speculative mode (`draft_model=<TorchBundle>`, `gamma`): each tick the
draft proposes gamma tokens for every slot — gamma + 1 slot steps over a
dense draft cache, the last only writing its gamma-th proposal's K/V —
then ONE target slot-block step of [S, gamma + 1] verifies every slot's
proposals at its own position, over the dense cache or the page pools
(a block over pools gathers the pages: no paged kernel launches in a
speculative tick).  Each live slot emits its accepted prefix and the
target's own token, so every stream is still `generate()`'s.  The
proposals stay on the device until one read-back a tick, with the
target's predictions.  A quant bundle (`quant=True`, prequantized or
not) serves as any other: each bucket and tick runs its int8 layers over
the same rows as the JAX package's batcher.

Compose with serving: `stream_reply(lambda row: batcher.stream_text(...))`
gives token-by-token HTTP with cross-request batching on the device.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from queue import Empty, Queue
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..core import telemetry
from ..core.flow import AdmissionStage, FlowGraph, Stage
from ..device import resolve_device
from ..io.feed import DeviceFeed
from ..models.bundle import TorchBundle
from ..models.generation import _module_for, _prefill_kv
from ..utils.sync import make_rlock

__all__ = ["ContinuousBatcher", "PrefillStage", "TokenStream"]


class PrefillStage(Stage):
    """Host-side prompt packing for admission prefill buckets, as a
    registered flow stage: bucket i+1 packs on a flow worker while
    bucket i's prefill forward occupies the device.  The bounded credit
    budget caps how many packed buckets stage ahead of the device."""

    name = "prefill"
    credits = 4


class TokenStream:
    """Iterator over one request's generated token ids (host ints).
    Blocks until tokens arrive; ends when the request finishes.  A
    request the scheduler had to abandon closes the stream with `error`
    set and iteration raises it — consumers must never block forever on
    a request that cannot run."""

    def __init__(self):
        # one request's tokens, capped by its max_new_tokens; bounding it
        # would let one slow client stall the batch loop for every slot
        self._q: "Queue[Optional[int]]" = Queue()  # graftlint: disable=G403
        self.error: Optional[BaseException] = None

    def __iter__(self) -> Iterator[int]:
        return self._iter(None)

    def _iter(self, timeout: Optional[float]) -> Iterator[int]:
        while True:
            try:
                tok = self._q.get(timeout=timeout)
            except Empty:
                raise TimeoutError(
                    f"no token within {timeout} s: the batcher loop is "
                    "stalled or dead") from None
            if tok is None:
                if self.error is not None:
                    raise self.error
                return
            yield tok

    def tokens(self, timeout: Optional[float] = None) -> List[int]:
        """Drain the whole stream (blocking); with `timeout`, raise
        TimeoutError when no token arrives within that many seconds."""
        return list(self._iter(timeout))


class _Request:
    def __init__(self, prompt: np.ndarray, max_new_tokens: int,
                 eos_id: Optional[int], prefix: Optional[int] = None,
                 deadline: Optional[float] = None):
        self.prompt = prompt          # FULL ids (shared prefix + suffix)
        self.max_new = int(max_new_tokens)
        self.eos_id = eos_id
        self.prefix = prefix          # register_prefix handle, or None
        self.deadline = deadline      # absolute monotonic admission budget
        self.stream = TokenStream()
        self.emitted = 0
        # submitter's trace context: admission latency is attributed back
        # to the submitting request's span (the loop is another thread)
        self.trace = telemetry.current_context()
        self.submitted_at = time.monotonic()


def _pow2_rows(k: int, cap: int) -> int:
    """k rows padded to a power of two, at most `cap`."""
    kp = 1
    while kp < k:
        kp *= 2
    return min(kp, cap)


class ContinuousBatcher:
    """Schedule many decode streams onto one slotted device batch.

    bundle: a TransformerLM `TorchBundle`; it runs on `device` (``cuda``
    unless the caller passes another, as `generate` does).  `max_slots`
    is the device batch width.

    `draft_model` turns on speculative continuous batching: a
    TransformerLM `TorchBundle` (the port has no (model, variables)
    pair, so the draft is a bundle, like the target) sharing the
    target's vocabulary — a smaller model, a distilled student or the
    target's prequantized int8 copy — proposing `gamma` tokens a slot a
    tick.  An MoE target needs drop-free capacity (`moe_capacity >=
    moe_experts`): its capacity scales with the tokens a forward, so a
    verify block could drop tokens that one-token steps keep."""

    def __init__(self, bundle: TorchBundle, max_slots: int = 8,
                 idle_sleep_s: float = 0.001,
                 max_pending: Optional[int] = None,
                 kv_cache_dtype: Optional[str] = None,
                 paged: bool = False, page_size: int = 64,
                 num_pages: Optional[int] = None,
                 draft_model=None, gamma: int = 4, device=None):
        if kv_cache_dtype not in (None, "int8"):
            raise ValueError(f"kv_cache_dtype must be None or 'int8', "
                             f"got {kv_cache_dtype!r}")
        if draft_model is not None and not isinstance(draft_model,
                                                      TorchBundle):
            raise TypeError(f"draft_model must be a TransformerLM "
                            f"TorchBundle, got {type(draft_model).__name__}")
        self.device = resolve_device(device)
        self.model = _module_for(bundle, self.device)
        model = self.model
        self.draft = None
        if draft_model is not None:
            self.draft = _module_for(draft_model, self.device)
            if self.draft.vocab_size != model.vocab_size:
                raise ValueError("draft and target must share a vocabulary")
            if gamma < 1:
                raise ValueError(f"gamma must be >= 1, got {gamma}")
            if model.moe_experts > 0 and model.moe_capacity < model.moe_experts:
                raise ValueError(
                    "speculative batching with MoE needs drop-free "
                    f"capacity: set moe_capacity >= moe_experts "
                    f"({model.moe_experts}), got {model.moe_capacity}")
        # verify blocks write up to gamma rows past the emitted position
        self.gamma = int(gamma) if draft_model is not None else 0
        # every host->device upload (the tick's tok/pos/page-table
        # vectors, admission prefill batches) rides the feed engine: the
        # tick's small arrays byte-pack into ONE copy
        self._feed = DeviceFeed(self.device)
        self.max_slots = int(max_slots)
        self.idle_sleep_s = float(idle_sleep_s)
        # bounded intake: submit() sheds (raises Overloaded) once this many
        # requests wait for a slot; None = unbounded
        self.max_pending = None if max_pending is None else int(max_pending)
        self.kv_cache_dtype = kv_cache_dtype
        self.paged = bool(paged)
        s, L = self.max_slots, model.max_len
        h = model.kv_heads
        d = model.embed_dim // model.num_heads
        if self.paged:
            # per-layer PAGE POOLS shared by every slot + a [S, MP] page
            # table.  Admission reserves each request's WORST-CASE page
            # count up front (counts only; allocation stays lazy), so a
            # running stream can never hit pool exhaustion mid-decode.
            # Physical page 0 is the write-trash page: free slots' dead
            # writes and unallocated table entries land there.
            if L % int(page_size):
                raise ValueError(
                    f"page_size {page_size} must divide max_len {L}")
            self.page_size = int(page_size)
            self._mp = L // self.page_size          # max pages per slot
            self._np = (int(num_pages) if num_pages is not None
                        else s * self._mp + 1)      # default: dense parity
            if self._np < 2:
                raise ValueError("num_pages must be >= 2 (page 0 is trash)")
            shape4 = (self._np, self.page_size, h, d)
            shape3 = (self._np, self.page_size, h)
            self._free: List[int] = list(range(1, self._np))
            self._avail = len(self._free)           # unreserved budget
            self._slot_pages: List[List[int]] = [[] for _ in range(s)]
            self._slot_reserved = [0] * s
            self._slot_shared = [0] * s   # leading SHARED-prefix pages
            self._table = np.zeros((s, self._mp), np.int32)
            self._prefixes: dict = {}     # handle -> shared-prefix record
            self._next_prefix = 1
        else:
            shape4, shape3 = (s, L, h, d), (s, L, h)
        dt = next(model.parameters()).dtype
        # the pools are made in inference mode: the loop thread (which
        # runs in it) writes them in place
        with torch.inference_mode():
            if kv_cache_dtype == "int8":
                layer = lambda: (  # noqa: E731
                    torch.zeros(shape4, dtype=torch.int8, device=self.device),
                    torch.zeros(shape3, dtype=torch.float32,
                                device=self.device),
                    torch.zeros(shape4, dtype=torch.int8, device=self.device),
                    torch.zeros(shape3, dtype=torch.float32,
                                device=self.device))
            else:
                layer = lambda: (  # noqa: E731
                    torch.zeros(shape4, dtype=dt, device=self.device),
                    torch.zeros(shape4, dtype=dt, device=self.device))
            self._cache = tuple(layer() for _ in range(model.num_layers))
            if self.draft is not None:
                # the draft's plain DENSE slot cache (the cheap model:
                # paging and int8 buy nothing there), at the same logical
                # positions as the target's
                dd = self.draft
                dshape = (s, dd.max_len, dd.kv_heads,
                          dd.embed_dim // dd.num_heads)
                ddt = next(dd.parameters()).dtype
                self._d_cache = tuple(
                    (torch.zeros(dshape, dtype=ddt, device=self.device),
                     torch.zeros(dshape, dtype=ddt, device=self.device))
                    for _ in range(dd.num_layers))
        self._pos = np.zeros(s, np.int32)
        self._tok = np.zeros(s, np.int32)
        self._live: List[Optional[_Request]] = [None] * s
        # the intake: bounded shed at submit() (Overloaded/503 past
        # max_pending), expired-deadline reaping and graceful drain
        self._intake = AdmissionStage(
            max_pending=self.max_pending, label="batcher",
            shed_counter="batcher.shed",
            expired_counter="batcher.deadline_expired",
            depth_gauge="serving.batcher.queue_depth")
        # loop-thread-only FIFO between intake and admission: paged mode
        # may defer the queue head until enough pages free up
        self._buffer: "deque[_Request]" = self._intake.buffer
        # control ops (prefix register/release) serviced by the loop
        # thread, which owns the pool/free-list/device cache
        self._ctl: Queue = Queue()  # graftlint: disable=G403
        self._running = threading.Event()
        self._stopped = False
        # the loop thread's fatal error, if it died
        self.error: Optional[BaseException] = None
        # serializes the stopped-check+enqueue in submit() against stop()'s
        # drain.  RLock: _ctl_call executes control ops INLINE under this
        # lock when no loop thread runs, and _exec_release_prefix
        # re-acquires it
        self._submit_lock = make_rlock("serving.batcher.submit")
        self._thread: Optional[threading.Thread] = None

    def _step(self, tok, pos, table):
        """One slot decode_step over every layer's cache, in place."""
        logits, self._cache = self.model.decode_step(tok, self._cache, pos,
                                                     table)
        return logits

    def _page_ceiling(self) -> int:
        """Pages that can EVER be simultaneously free for one request:
        the pool minus every registered prefix's held pages.  submit()'s
        reject and _try_admit()'s drop share this expression."""
        return self._np - 1 - sum(
            r["shared"] for r in self._prefixes.values())

    def _worst_pages(self, prompt_len: int, max_new: int,
                     shared_pages: int = 0) -> int:
        """Worst-case page count for one request — THE reservation
        invariant: submit()'s rejection and _try_admit()'s reservation
        both use exactly this, or just-in-time growth in the loop could
        pop an empty free list mid-decode.  Speculative mode writes up to
        `gamma` rows past the emitted position, so it covers them too.  A
        shared prefix's leading pages are the HANDLE's, not the
        request's."""
        return min(-(-(prompt_len + max_new + self.gamma)
                     // self.page_size), self._mp) - shared_pages

    # ---- shared-prefix caching (paged mode) ----------------------------
    def _ctl_call(self, op, payload):
        rec = {"op": op, "payload": payload, "event": threading.Event(),
               "result": None, "error": None}
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("ContinuousBatcher is stopped")
            # inline only while no loop thread can possibly be running;
            # the inline execution stays UNDER the lock, so a racing
            # start() cannot spawn a ticking loop meanwhile
            alive = self._thread is not None and self._thread.is_alive()
            if alive:
                self._ctl.put(rec)
            else:
                with torch.inference_mode():
                    return op(payload)
        if not rec["event"].wait(timeout=300):
            raise RuntimeError("batcher loop did not service the request")
        if rec["error"] is not None:
            raise rec["error"]
        return rec["result"]

    def register_prefix(self, prefix_ids) -> int:
        """Prefill a shared prompt prefix (system prompt) ONCE into
        dedicated read-only pages; `submit(..., prefix=handle)` requests
        then reuse them — admission prefills only each request's suffix,
        attending over the shared pages through its page table.  Only
        the full pages share (floor(len/page) * page tokens); the
        remainder rides with each request's suffix.  Returns a handle for
        submit()/release_prefix()."""
        if not self.paged:
            raise ValueError("prefix caching needs paged=True")
        ids = np.asarray(prefix_ids, np.int32).reshape(-1)
        if len(ids) < 1:
            raise ValueError("empty prefix")
        if len(ids) + 1 + self.gamma > self.model.max_len:
            raise ValueError("prefix leaves no room to generate")
        if (self.draft is not None
                and len(ids) + 1 + self.gamma > self.draft.max_len):
            # the dense draft cache holds the FULL prompt (prefix + suffix)
            raise ValueError(
                f"prefix of {len(ids)} tokens exceeds the draft model's "
                f"max_len {self.draft.max_len} - 1 - gamma {self.gamma} "
                "(speculative mode prefills the full prompt into the "
                "draft cache)")
        return self._ctl_call(self._exec_register_prefix, ids)

    def release_prefix(self, handle: int):
        """Free a prefix's shared pages.  Refuses while any live or
        pending request still uses it."""
        return self._ctl_call(self._exec_release_prefix, int(handle))

    def _exec_register_prefix(self, ids) -> int:
        shared = len(ids) // self.page_size          # full pages only
        if shared > self._avail:
            raise ValueError(
                f"prefix needs {shared} pages but only {self._avail} "
                "are unreserved")
        self._avail -= shared
        pages = [self._free.pop() for _ in range(shared)]
        try:
            padded = np.zeros((1, self._bucket(len(ids))), np.int32)
            padded[0, :len(ids)] = ids
            logits, rows = _prefill_kv(self.model, self._feed.put(padded),
                                       self.kv_cache_dtype)
            if shared:
                self._scatter_pages(rows, [(0, pages,
                                            shared * self.page_size)])
            last_logits = logits[0, len(ids) - 1].float().cpu().numpy()
        except Exception:
            # a failed prefill must not leak the pool allocation
            self._free.extend(pages)
            self._avail += shared
            raise
        handle = self._next_prefix
        self._next_prefix += 1
        # under _submit_lock: submit() iterates _prefixes.values() for the
        # page ceiling under this lock from client threads
        with self._submit_lock:
            self._prefixes[handle] = {
                "ids": ids, "pages": pages, "shared": shared,
                # logits at the last prefix position: the first generated
                # token when a request adds no suffix
                "last_logits": last_logits,
                "refs": 0,
            }
        return handle

    def _exec_release_prefix(self, handle: int):
        # the refs check + delete serialize against submit()'s refs
        # increment (both under _submit_lock)
        with self._submit_lock:
            rec = self._prefixes[handle]
            if rec["refs"] > 0:
                raise ValueError(f"prefix {handle} still has "
                                 f"{rec['refs']} active request(s)")
            del self._prefixes[handle]
        self._free.extend(rec["pages"])
        self._avail += rec["shared"]

    # ---- client side ---------------------------------------------------
    def submit(self, prompt_ids, max_new_tokens: int = 32,
               eos_id: Optional[int] = None,
               prefix: Optional[int] = None,
               deadline: Optional[float] = None) -> TokenStream:
        """`prefix`: a register_prefix handle — `prompt_ids` is then the
        SUFFIX appended to the shared prefix (may be empty), and
        admission prefills only the suffix.

        `deadline`: absolute `time.monotonic()` budget for ADMISSION — a
        request still waiting for a slot past it is failed fast with a
        TimeoutError on its stream instead of being computed (already
        admitted streams run to completion).  Load shedding: when
        `max_pending` is set and that many requests already wait,
        submit raises Overloaded (serving maps it to 503 + Retry-After)."""
        self._intake.shed_check()
        shared_pages = 0
        if prefix is not None:
            if not self.paged:
                raise ValueError("prefix caching needs paged=True")
            try:
                rec = self._prefixes[prefix]
            except KeyError:
                raise ValueError(f"unknown or released prefix {prefix}")
            prompt = np.concatenate(
                [rec["ids"], np.asarray(prompt_ids, np.int32).reshape(-1)])
            shared_pages = rec["shared"]
        else:
            prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) < 1:
            raise ValueError("empty prompt")
        limit = self.model.max_len - self.gamma
        if self.draft is not None:
            # draft writes ride to the same positions (+gamma lookahead)
            limit = min(limit, self.draft.max_len - self.gamma)
        if len(prompt) + max_new_tokens > limit:
            raise ValueError(
                f"prompt {len(prompt)} + {max_new_tokens} exceeds "
                f"max_len {self.model.max_len}"
                + (f" - gamma {self.gamma} (speculative lookahead)"
                   if self.gamma else ""))
        req = _Request(prompt, max_new_tokens, eos_id, prefix=prefix,
                       deadline=deadline)
        with self._submit_lock:
            if self.paged:
                worst = self._worst_pages(len(prompt), int(max_new_tokens),
                                          shared_pages)
                # pages held by other prefixes never return to _avail, so
                # a request that only fits without them would sit at the
                # FIFO head forever, wedging everyone behind it
                ceiling = self._page_ceiling()
                if worst > ceiling:
                    raise ValueError(
                        f"request needs up to {worst} pages but only "
                        f"{ceiling} of the pool's {self._np - 1} can ever "
                        "free up (registered prefixes hold the rest); "
                        "raise num_pages or release prefixes")
            if self._stopped:
                # a late submit racing stop() would otherwise wait forever
                # on a stream nobody will ever close
                raise RuntimeError("ContinuousBatcher is stopped")
            if self.error is not None:
                raise RuntimeError("the batcher loop died") from self.error
            if prefix is not None:
                if prefix not in self._prefixes:  # released since lookup
                    raise ValueError(f"prefix {prefix} was released")
                self._prefixes[prefix]["refs"] += 1
            self._intake.put(req)
        return req.stream

    def stream_text(self, tokenizer, text: str,
                    max_new_tokens: int = 32) -> Iterator[str]:
        """serving.stream_reply-ready: text in, decoded word chunks out.

        Ids buffer until a token COMPLETES a word (tokenizer.is_word_end),
        then the whole word decodes as one piece — a word split across
        subword tokens never streams with spaces inside it.  Tokenizers
        without the concept degrade to per-token emission."""
        ids = tokenizer.encode(text, append_eos=False)
        word_end = getattr(tokenizer, "is_word_end", lambda _t: True)
        buf: List[int] = []
        for tok in self.submit(ids, max_new_tokens,
                               eos_id=tokenizer.eos_id):
            buf.append(tok)
            if word_end(tok):
                piece = tokenizer.decode(buf)
                buf.clear()
                if piece:
                    yield piece + " "
        if buf:  # stream ended mid-word (max_new_tokens hit)
            piece = tokenizer.decode(buf)
            if piece:
                yield piece + " "

    # ---- scheduler loop ------------------------------------------------
    def start(self) -> "ContinuousBatcher":
        # under _submit_lock: _ctl_call's inline path decides "no loop
        # thread is running" and mutates pool state under this lock
        with self._submit_lock:
            self._running.set()
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="continuous-batcher")
            self._thread.start()
        return self

    def stop(self):
        with self._submit_lock:
            # after this block no submit() can enqueue, so the drain
            # below is complete
            self._stopped = True
        self._running.clear()
        if self._thread is not None:
            # the drain below treats _buffer/_live as single-owner, so the
            # loop thread must actually be DEAD first
            self._thread.join(timeout=300)
            if self._thread.is_alive():
                raise RuntimeError(
                    "ContinuousBatcher loop thread failed to exit within "
                    "300s; refusing to drain its queues concurrently")
        # unblock any consumers still waiting on admitted streams
        for req in self._live:
            if req is not None:
                req.stream._q.put(None)
        self._intake.drain_all(lambda req: req.stream._q.put(None))
        while True:  # unblock any caller waiting on a control op
            try:
                rec = self._ctl.get_nowait()
            except Empty:
                break
            rec["error"] = RuntimeError("ContinuousBatcher is stopped")
            rec["event"].set()

    def _bucket(self, n: int) -> int:
        """Power-of-two prompt bucket (16 .. max_len): admission runs
        O(log max_len) prefill shapes.  The padded tail is sound: causal
        masking keeps positions < n exact, and the garbage K/V rows >= n
        are never attendable — a decode step at pos p masks rows > p and
        overwrites row p itself first."""
        b = 16
        while b < n:
            b *= 2
        b = min(b, self.model.max_len)
        if self.draft is not None:
            b = min(b, self.draft.max_len)
        return b

    def _scatter_pages(self, rows, placements):
        """Write prefill cache rows into the pools: `placements` lists
        (prefill row i, its pages, n) — row i's positions 0..n-1 go to
        pages[t // page] at row t % page.  One indexed write per pool."""
        page = self.page_size
        src_row, src_pos, dst_pg, dst_off = [], [], [], []
        for i, pages, n in placements:
            t = np.arange(n)
            src_row.append(np.full(n, i))
            src_pos.append(t)
            dst_pg.append(np.asarray(pages, np.int64)[t // page])
            dst_off.append(t % page)
        idx = self._feed.put_group([np.concatenate(x).astype(np.int64)
                                    for x in (src_row, src_pos, dst_pg,
                                              dst_off)])
        for layer, layer_rows in zip(self._cache, rows):
            for pool, r in zip(layer, layer_rows):
                pool[idx[2], idx[3]] = r[idx[0], idx[1]].to(pool.dtype)

    def _load_draft(self, d_padded, slots):
        """The draft's prefill of prompts `d_padded` [kp, bucket] (on the
        device), its cache rows written into the draft cache at `slots`
        (the first len(slots) rows).  Its logits are unused: a stream's
        first token is the TARGET's."""
        _dlg, d_rows = _prefill_kv(self.draft, d_padded)
        k, width = len(slots), d_padded.shape[1]
        idx = torch.as_tensor(slots, device=self.device)
        for layer, layer_rows in zip(self._d_cache, d_rows):
            for dst, r in zip(layer, layer_rows):
                dst[idx, :width] = r[:k].to(dst.dtype)

    def _first_tokens(self, logits, last_pos) -> np.ndarray:
        """argmax of each row's logits at its last prompt position (one
        read back)."""
        idx = torch.as_tensor(np.asarray(last_pos, np.int64),
                              device=logits.device)
        rows = torch.arange(len(last_pos), device=logits.device)
        return logits[rows, idx].argmax(-1).to(torch.int32).cpu().numpy()

    def _admit_batch(self, batch):
        """Admit several (slot, request) pairs with ONE prefill forward
        per prompt bucket.  Row counts pad to powers of two (capped at
        max_slots); pad rows compute garbage nobody reads."""
        now = time.monotonic()
        for slot, req in batch:
            # slot-wait span on the SUBMITTER's trace (cross-thread hop)
            if req.trace is not None:
                telemetry.record_span("serving.batcher.admit", req.trace,
                                      now - req.submitted_at, slot=slot)
        by_bucket: dict = {}
        prefix_groups: dict = {}
        for slot, req in batch:
            if req.prefix is not None:
                rec = self._prefixes[req.prefix]
                rest = len(req.prompt) - rec["shared"] * self.page_size
                rb = self._bucket(max(rest, 1)) if rest else 0
                prefix_groups.setdefault(rb, []).append((slot, req))
            else:
                by_bucket.setdefault(self._bucket(len(req.prompt)),
                                     []).append((slot, req))
        if prefix_groups:
            self._admit_prefix_groups(prefix_groups)

        def pack_bucket(item):
            # host-side prompt packing for one bucket; runs on a flow
            # worker so bucket i+1 packs while bucket i's prefill runs
            b, group = item
            kp = _pow2_rows(len(group), self.max_slots)
            padded = np.zeros((kp, b), np.int32)
            for i, (_slot, req) in enumerate(group):
                padded[i, :len(req.prompt)] = req.prompt
            return group, padded

        buckets = sorted(by_bucket.items())
        if len(buckets) > 1:
            packed = FlowGraph([PrefillStage(fn=pack_bucket)],
                               label="prefill").run(buckets)
        else:  # one bucket: nothing to overlap, skip the worker thread
            packed = map(pack_bucket, buckets)
        for group, padded in packed:
            d_padded = self._feed.put(padded)
            logits, rows = _prefill_kv(self.model, d_padded,
                                       self.kv_cache_dtype)
            if self.draft is not None:
                # the draft's cache holds the same prompt history
                self._load_draft(d_padded, [slot for slot, _r in group])
            if self.paged:
                # allocate each slot's prompt pages and scatter all rows'
                # prompt positions in one write per pool
                placements = []
                for i, (slot, req) in enumerate(group):
                    need = -(-len(req.prompt) // self.page_size)
                    pages = [self._free.pop() for _ in range(need)]
                    self._slot_pages[slot] = pages
                    self._slot_shared[slot] = 0
                    self._table[slot].fill(0)
                    self._table[slot, :need] = pages
                    placements.append((i, pages, len(req.prompt)))
                self._scatter_pages(rows, placements)
            else:
                k = len(group)
                slots = torch.as_tensor([slot for slot, _r in group],
                                        device=self.device)
                width = padded.shape[1]
                for layer, layer_rows in zip(self._cache, rows):
                    for dst, r in zip(layer, layer_rows):
                        dst[slots, :width] = r[:k].to(dst.dtype)
            firsts = self._first_tokens(
                logits, [len(r.prompt) - 1 for _s, r in group])
            for i, (slot, req) in enumerate(group):
                self._live[slot] = req
                self._pos[slot] = len(req.prompt)
                self._tok[slot] = int(firsts[i])
                self._emit(slot, int(firsts[i]))

    def _admit_prefix_groups(self, prefix_groups):
        """Admit shared-prefix requests: wire each slot's page table to
        the prefix's read-only pages + freshly allocated own pages, then
        prefill ONLY the suffix via one slot-BLOCK decode per rest
        bucket (the block attends the shared rows through the table).
        rest=0 requests skip the forward entirely: their first token
        comes from the logits the prefix registration stored.  In
        speculative mode the dense draft cache cannot share pages: the
        draft prefills the FULL prompts, batched per bucket."""
        if self.draft is not None:
            by_draft_bucket: dict = {}
            for group in prefix_groups.values():
                for slot, req in group:
                    by_draft_bucket.setdefault(
                        self._bucket(len(req.prompt)), []).append((slot, req))
            for db, dgroup in sorted(by_draft_bucket.items()):
                dpad = np.zeros((_pow2_rows(len(dgroup), self.max_slots), db),
                                np.int32)
                for i, (_slot, req) in enumerate(dgroup):
                    dpad[i, :len(req.prompt)] = req.prompt
                self._load_draft(self._feed.put(dpad),
                                 [slot for slot, _r in dgroup])
        for rb, group in sorted(prefix_groups.items()):
            fill = []                  # rows that need a suffix forward
            for slot, req in group:
                rec = self._prefixes[req.prefix]
                shared = rec["shared"]
                shared_tokens = shared * self.page_size
                n = len(req.prompt)
                need = -(-n // self.page_size) - shared
                pages = [self._free.pop() for _ in range(need)]
                self._slot_pages[slot] = pages
                self._slot_shared[slot] = shared
                self._table[slot].fill(0)
                self._table[slot, :shared] = rec["pages"]
                self._table[slot, shared:shared + need] = pages
                if n > shared_tokens:
                    fill.append((slot, req, shared_tokens))
                else:
                    first = int(np.argmax(rec["last_logits"]))
                    self._live[slot] = req
                    self._pos[slot] = n
                    self._tok[slot] = first
                    self._emit(slot, first)
            if not fill:
                continue
            kp = _pow2_rows(len(fill), self.max_slots)
            toks = np.zeros((kp, rb), np.int32)
            pos = np.zeros(kp, np.int32)
            tables = np.zeros((kp, self._mp), np.int32)
            for i, (slot, req, st) in enumerate(fill):
                toks[i, :len(req.prompt) - st] = req.prompt[st:]
                pos[i] = st
                tables[i] = self._table[slot]
            logits = self._step(*self._feed.put_group([toks, pos, tables]))
            firsts = self._first_tokens(
                logits, [len(r.prompt) - st - 1 for _s, r, st in fill])
            for i, (slot, req, _st) in enumerate(fill):
                self._live[slot] = req
                self._pos[slot] = len(req.prompt)
                self._tok[slot] = int(firsts[i])
                self._emit(slot, int(firsts[i]))

    def _emit(self, slot: int, tok: int):
        req = self._live[slot]
        req.emitted += 1
        req.stream._q.put(tok)
        done = (req.emitted >= req.max_new
                or (req.eos_id is not None and tok == req.eos_id)
                or int(self._pos[slot]) + 1 >= self.model.max_len)
        if done:
            req.stream._q.put(None)
            self._live[slot] = None
            # park the freed slot at position 0: a stale position near
            # max_len plus the speculative lookahead would pass the cache
            self._pos[slot] = 0
            self._tok[slot] = 0
            if self.paged:  # return OWNED pages + release the reservation
                self._free.extend(self._slot_pages[slot])
                self._slot_pages[slot] = []
                self._slot_shared[slot] = 0
                self._table[slot].fill(0)
                self._avail += self._slot_reserved[slot]
                self._slot_reserved[slot] = 0
                if req.prefix is not None:
                    with self._submit_lock:
                        self._prefixes[req.prefix]["refs"] -= 1

    def _drain_intake(self):
        while True:  # control ops first: admissions may depend on them
            try:
                rec = self._ctl.get_nowait()
            except Empty:
                break
            try:
                rec["result"] = rec["op"](rec["payload"])
            except Exception as e:  # noqa: BLE001 — surfaced to the caller
                rec["error"] = e
            rec["event"].set()
        self._intake.drain_to_buffer()

    def _try_admit(self):
        """Admit from the FIFO head into free slots — collected into ONE
        batched prefill (_admit_batch).  Paged mode admits only while
        the head's worst-case page reservation fits the unreserved
        budget — strict FIFO (no skipping), so a big request can't be
        starved by a stream of small ones."""
        if self.paged:
            # fail-fast pre-pass: a prefix registered AFTER a request
            # passed submit()'s ceiling check can shrink the achievable
            # budget below its reservation — a head that can NEVER fit
            # must error its stream, not wedge the FIFO forever
            ceiling = self._page_ceiling()
            while self._buffer:
                head = self._buffer[0]
                shared = (self._prefixes[head.prefix]["shared"]
                          if head.prefix is not None else 0)
                if self._worst_pages(len(head.prompt), head.max_new,
                                     shared) <= ceiling:
                    break
                self._buffer.popleft()
                if head.prefix is not None:
                    with self._submit_lock:
                        self._prefixes[head.prefix]["refs"] -= 1
                head.stream.error = RuntimeError(
                    "request dropped: its worst-case page reservation "
                    f"exceeds the {ceiling} pages that can ever free up "
                    "(prefixes registered after submit hold the rest)")
                head.stream._q.put(None)
        if any(r.deadline is not None for r in self._buffer):
            # fail-fast: an expired request must not consume a prefill —
            # its client has already given up
            def _expire(req: _Request):
                if req.prefix is not None:
                    with self._submit_lock:
                        self._prefixes[req.prefix]["refs"] -= 1
                req.stream.error = TimeoutError(
                    "request deadline expired before batch admission")
                req.stream._q.put(None)

            self._intake.reap_expired(lambda r: r.deadline, _expire)
        batch = []
        for slot in range(self.max_slots):
            if not self._buffer:
                break
            if self._live[slot] is not None:
                continue
            req = self._buffer[0]
            if self.paged:
                shared = (self._prefixes[req.prefix]["shared"]
                          if req.prefix is not None else 0)
                worst = self._worst_pages(len(req.prompt), req.max_new,
                                          shared)
                if worst > self._avail:
                    break
                self._avail -= worst
                self._slot_reserved[slot] = worst
            self._buffer.popleft()
            batch.append((slot, req))  # each slot index visited once
        if batch:
            self._admit_batch(batch)

    def _loop(self):
        try:
            with torch.inference_mode():
                while self._running.is_set():
                    self._tick()
        except BaseException as e:  # noqa: BLE001 — settled, re-raised
            # fail every admitted and queued stream instead of leaving its
            # consumer blocked; under the submit lock, so no submit slips
            # in after the drain (submit refuses once `error` is set)
            err = RuntimeError(f"the batcher loop died: {e!r}")
            err.__cause__ = e

            def settle(req):
                req.stream.error = err
                req.stream._q.put(None)

            with self._submit_lock:
                self.error = e
                self._running.clear()
                for req in self._live:
                    if req is not None:
                        settle(req)
                self._live = [None] * self.max_slots
                self._intake.drain_all(settle)
            raise

    def _tick(self):
        self._drain_intake()
        self._try_admit()
        active = [s for s in range(self.max_slots)
                  if self._live[s] is not None]
        if not active:
            if not self._buffer:
                try:
                    self._buffer.append(
                        self._intake.get(timeout=self.idle_sleep_s))
                except Empty:
                    pass
            # nothing live -> every reservation is released, so the head
            # always fits; the next iteration admits it
            return
        telemetry.histogram("serving.batcher.batch_fill").observe(
            len(active) / self.max_slots)
        if self.paged:
            # grow each active slot's page list just-in-time for this
            # tick's write positions, up to pos + gamma in speculative
            # mode (the admission reservation guarantees the free list
            # can cover them)
            for sl in active:
                idx = (int(self._pos[sl]) + self.gamma) // self.page_size
                while idx >= (self._slot_shared[sl]
                              + len(self._slot_pages[sl])):
                    pg = self._free.pop()
                    self._table[sl, self._slot_shared[sl]
                                + len(self._slot_pages[sl])] = pg
                    self._slot_pages[sl].append(pg)
        if self.draft is not None:
            self._speculative_tick(active)
            return
        # ONE batched step for every slot (free slots compute too — their
        # pos 0 writes are dead: dense mode overwrites the rows on admit,
        # paged mode routes them to the trash page), fed by ONE packed
        # upload of this tick's tok/pos(/table) vectors
        if self.paged:
            d_tok, d_pos, d_tbl = self._feed.put_group(
                [self._tok[:, None], self._pos, self._table])
        else:
            d_tok, d_pos = self._feed.put_group(
                [self._tok[:, None], self._pos])
            d_tbl = None
        lg = self._step(d_tok, d_pos, d_tbl)
        nxt = lg[:, 0].argmax(-1).to(torch.int32).cpu().numpy()
        for slot in active:
            self._pos[slot] += 1
            self._tok[slot] = nxt[slot]
            self._emit(slot, int(nxt[slot]))

    def _speculative_tick(self, active):
        """One speculative round for ALL slots: gamma + 1 draft slot steps
        propose (the last only writes the gamma-th proposal's K/V, so a
        fully accepted round leaves no hole in the draft cache), ONE
        target slot-block step verifies, and each live slot emits its
        accepted prefix and the target's own next token —
        `speculative_generate`'s round over co-tenant slots.  The draft
        steps over every slot, idle ones included, as the target's tick
        does.  One upload and one read-back a tick."""
        g = self.gamma
        if self.paged:
            d_tok, d_pos, d_tbl = self._feed.put_group(
                [self._tok[:, None], self._pos, self._table])
        else:
            d_tok, d_pos = self._feed.put_group(
                [self._tok[:, None], self._pos])
            d_tbl = None
        tok, props = d_tok, []
        for i in range(g + 1):
            lg, self._d_cache = self.draft.decode_step(tok, self._d_cache,
                                                       d_pos + i)
            tok = lg[:, 0].argmax(-1, keepdim=True).to(torch.int32)
            if i < g:
                props.append(tok)
        # ONE target forward verifies every slot's pending token and its
        # g proposals at the slot's own position: logits[:, j] predicts
        # position pos + j + 1
        props = torch.cat(props, dim=1)                          # [S, g]
        lg = self._step(torch.cat([d_tok, props], dim=1), d_pos, d_tbl)
        t_pred = lg.argmax(-1).to(torch.int32)                   # [S, g+1]
        both = torch.cat([props, t_pred], dim=1).cpu().numpy()
        props, t_pred = both[:, :g], both[:, g:]
        for slot in active:
            match = np.append(t_pred[slot, :g] == props[slot], False)
            m = int(np.argmin(match))                            # 0..g
            for j in range(m + 1):
                tok = int(props[slot, j]) if j < m else int(t_pred[slot, m])
                self._pos[slot] += 1
                self._tok[slot] = tok
                self._emit(slot, tok)
                if self._live[slot] is None:
                    break  # finished mid-block: the rest is discarded
