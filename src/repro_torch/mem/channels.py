"""Split request/response memory channels — TAPA's ``async_mmap`` idiom.

A traditional HLS read (``d = mem[addr]``) issues one request and stalls
until its response returns: one outstanding transaction.  TAPA splits the
interface into a *request* stream and a *response* stream so a task can
keep issuing reads while earlier responses are still in flight
(``issue_read_addr`` / ``receive_read_resp`` — SNIPPETS.md §1).  An
:class:`AsyncMemChannel` reproduces that contract against the bank model:

* **request side** — :meth:`pump` issues read requests ahead of
  consumption every sweep, as long as the channel holds a free credit
  (``request_full`` is TAPA's ``mem.read_addr.full()``).  Credits bound
  the *outstanding* transactions: issued but not yet consumed.
* **response side** — the bank serves bursts; when a request's final burst
  lands, the response enters the bounded reorder window and becomes
  visible the next sweep.  :meth:`response_ready` is ``!read_data.empty()``,
  :meth:`consume` is ``read_data.read()``.  Responses are consumed in
  issue order (the window re-orders bank completions back to FIFO).

The payloads are supplied up front by the program binding
(``ProgramBinding.mem_reads``): the bank model decides *when* a response
arrives, never *what* it carries — which is why the bank-modeled execution
is bit-identical to the ideal path by construction.  Tokens are torch
tensors (or pytrees of them); their size is :func:`token_bytes`.  A copy of
the JAX package's ``mem/channels.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from ..exec.channels import token_bytes
from ..obs.trace import coerce_tracer
from .banks import MemorySystem


@dataclasses.dataclass
class MemChannelStats:
    """Measured per-memory-channel counters."""

    issued: int = 0                # read requests issued
    consumed: int = 0              # responses consumed by the task
    requested_bytes: int = 0       # bytes asked of the bank
    delivered_bytes: int = 0       # bytes whose response fully arrived
    blocked_issues: int = 0        # pump stalls on exhausted credits
    max_outstanding: int = 0       # issued-minus-consumed high-water mark
    response_waits: int = 0        # consume polls before the head ripened


class _Response:
    """One slot of the reorder window: visibility sweep (None in flight)."""

    __slots__ = ("vis", "token", "rid", "nbytes")

    def __init__(self, token: Any, rid: int, nbytes: int):
        self.vis: Optional[int] = None
        self.token = token
        self.rid = rid
        self.nbytes = nbytes


class AsyncMemChannel:
    """One task's named read stream against one (device, bank).

    ``tokens`` holds the per-firing payloads (``count`` of them will be
    fetched); ``device``/``bank`` place the stream on a physical bank;
    ``memsys=None`` is the ideal path — every response is ready
    immediately, the exact data the modeled path delivers later.
    """

    def __init__(self, index: int, task: str, stream: str,
                 tokens: Sequence[Any], count: int, *,
                 device: int, bank: int,
                 memsys: Optional[MemorySystem] = None,
                 tracer=None, trace_flow: int = 0):
        if len(tokens) < count:
            raise ValueError(
                f"memory stream {task}.{stream}: {len(tokens)} tokens < "
                f"{count} firings")
        self.index = index
        self.task = task
        self.stream = stream
        self.device = int(device)
        self.bank = int(bank)
        self.count = int(count)
        self.memsys = memsys
        self._tokens = list(tokens[:count])
        self._nbytes = [token_bytes(t) for t in self._tokens]
        self._window: List[_Response] = []    # issued, unconsumed (in order)
        self._by_rid: Dict[int, _Response] = {}
        self.stats = MemChannelStats()
        self.tracer = coerce_tracer(tracer)
        self.trace_flow = trace_flow

    # -- request side (issue_read_addr) -------------------------------------
    @property
    def outstanding(self) -> int:
        return len(self._window)

    @property
    def request_full(self) -> bool:
        """TAPA's ``mem.read_addr.full()`` — all credits are in flight."""
        if self.memsys is None:
            return False
        return self.outstanding >= self.memsys.config.credits

    @property
    def exhausted(self) -> bool:
        return self.stats.issued >= self.count

    def pump(self, sweep: int) -> int:
        """Issue read requests ahead of consumption while credits last
        (the multiple-outstanding-reads loop).  Returns requests issued."""
        issued = 0
        while not self.exhausted:
            if self.request_full:
                self.stats.blocked_issues += 1
                break
            i = self.stats.issued
            token, nbytes = self._tokens[i], self._nbytes[i]
            resp = _Response(token, rid=-1, nbytes=nbytes)
            if self.memsys is None:
                resp.vis = sweep                   # ideal: data is just there
            else:
                rid = self.memsys.submit(self.index, self.device, self.bank,
                                         nbytes, sweep)
                resp.rid = rid
                self._by_rid[rid] = resp
                if self.tracer.enabled:
                    self.tracer.mem_issue(
                        sweep, self.index, self.task, self.device,
                        self.memsys.bank_id(self.device, self.bank),
                        nbytes, self.trace_flow)
            self._window.append(resp)
            self.stats.issued += 1
            self.stats.requested_bytes += nbytes
            if self.memsys is None:
                self.stats.delivered_bytes += nbytes
            issued += 1
            self.stats.max_outstanding = max(self.stats.max_outstanding,
                                             self.outstanding)
        return issued

    # -- response side (receive_read_resp) ----------------------------------
    def on_complete(self, rid: int, sweep: int) -> None:
        """The bank served this request's final burst: the response lands
        in the reorder window, visible next sweep."""
        resp = self._by_rid.pop(rid)
        resp.vis = sweep + 1
        self.stats.delivered_bytes += resp.nbytes

    def response_ready(self, sweep: int) -> bool:
        """``!read_data.empty()`` — the *head* response (issue order) is
        here.  A later response that raced ahead still waits its turn."""
        if not self._window:
            return False
        head = self._window[0]
        ready = head.vis is not None and head.vis <= sweep
        if not ready:
            self.stats.response_waits += 1
        return ready

    def consume(self, sweep: int) -> Any:
        """``read_data.read()`` — pop the head response, freeing a credit."""
        if not self._window:
            raise RuntimeError(
                f"consume on empty memory stream {self.task}.{self.stream}")
        head = self._window[0]
        if head.vis is None or head.vis > sweep:
            raise RuntimeError(
                f"memory stream {self.task}.{self.stream}: head response "
                f"not ready at sweep {sweep}")
        self._window.pop(0)
        self.stats.consumed += 1
        return head.token

    # -- probes --------------------------------------------------------------
    def total_bursts(self) -> int:
        """Bank bursts this stream will demand over the whole run (the
        executor's sweep-bound heuristic); 0 on the ideal path."""
        if self.memsys is None:
            return 0
        cfg = self.memsys.config
        return sum(cfg.bursts_for(nb) for nb in self._nbytes)

    def pending_visibility(self) -> List[int]:
        """Sweeps at which delivered-but-unconsumed responses ripen (the
        executor's deadlock probe); in-flight requests report none — the
        memory system's ``active`` flag covers them."""
        return [r.vis for r in self._window if r.vis is not None]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"AsyncMemChannel({self.task}.{self.stream} -> dev "
                f"{self.device}/bank {self.bank}, "
                f"{self.stats.consumed}/{self.count} consumed, "
                f"{self.outstanding} outstanding)")
