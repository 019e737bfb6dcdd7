"""Execution context — the dispatch hub between model code and the kernels
and, on a grid, the collectives.

Counterpart of ``repro/parallel/context.py``.  Model code calls the
methods here and never the kernels or the collectives directly.

One device (``mesh=None``): every projection, the FFN, the LM head,
attention, MLA's absorbed decode, the SSD scan and the MoE's grouped
expert products and combine route through
``kernels/ops.py`` (the CUDA kernel for a CUDA tensor, the plain version
on the CPU).  One signal
picks the route, ``ops.needs_grad``: when autograd will differentiate,
projections, the head and the FFN's down-projection go through the
differentiable tile matmul, and the FFN's gated up-projection and
attention through their differentiable ops; otherwise (prefill and
decode, under ``inference_mode``) the forward-only kernels with fused
epilogues run.

The grid (``mesh`` a ``launch/mesh.Grid``, training): every method
takes and returns this rank's blocks.  Under ``pcfg.strategy ==
"hecaton"`` the residual stream stays in the canonical tiling (tokens
over ``mx``, hidden over ``my``); the projections are the hecaton ops of
``core/hecaton.py`` on the overlap lattice (``pcfg.overlap``, its ring
hops in ``pcfg.comm_dtype``); the norms sum their statistics over
``my`` (``comm.psum``), the embedding and the head use vocab chunks.
Where the
JAX package leaves a collective to GSPMD (a ``with_sharding_constraint``
between the ``shard_map`` ops), the port writes it out here: the norm's
``psum``, the K/V gather when the kv heads do not split over the grid,
the table's gather into the head's ``[H, V/my]`` layout.

Under ``"megatron"`` (the paper's baseline) the projections, the FFN,
the loss and the embedding are ``parallel/megatron.py``'s ops over the
one ``model`` axis (t_ax ``model``, no hidden axis): the norms are local
(the hidden dim is whole), the tied head is this rank's table block
transposed, and the residual layout (``pcfg.residual``) applies to the
step's global sequence length ``seq_len`` (a rank sees its block only):
``"seq"`` cuts it over ``model`` when the ring divides it, else every
rank of the axis holds it whole.

Serving on the grid takes JAX's two modes.  ``mode="prefill"`` runs
the strategy's dataflow as training does, without autograd, so
hecaton's projections are its grid ops (the ring kernels under
``overlap="fused"``) and the head is its seq-scatter linear.
``mode="decode"`` runs the 1D layout over the combined model axes with
the replicated residual whatever the strategy (DESIGN.md §4: a step of
one token cannot token-scatter): :attr:`strategy` is ``"megatron"``, so
every projection is ``parallel/megatron.py``'s over ``model`` (the
(mx, my) ranks row-major, the index JAX's ``("mx", "my")`` gives), and
the parameters must be in that layout (``serve/step.build_decode_step``
re-lays hecaton's tiles once).  On one device ``"serve"``, ``"prefill"``
and ``"decode"`` are the same.

``mode="train"`` only enables :meth:`dropout`, as in the JAX package.
MLA (``mla_decode``, ``mixer_in(interior=True)``) runs on one device
only; on the grid both raise.

``plain=True`` routes everything to the plain versions on any device,
differentiated by PyTorch's autograd: it is the reference that
``chip_smoke.py`` holds the kernel path (forward and gradients) against
on the card.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Optional

import torch

from repro_torch.config import ParallelConfig
from repro_torch.core import overlap as OV
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.launch.mesh import MODEL, Grid
from repro_torch.models import layers as L
from repro_torch.parallel import comm
from repro_torch.parallel import megatron as MEG
from repro_torch.parallel import sharding as shd

_PLAIN = SimpleNamespace(matmul=ref.matmul_plain,
                         gated_matmul=ref.gated_matmul_plain,
                         attention=ref.attention_plain,
                         tile_matmul=ref.tile_matmul_plain,
                         ssd=ref.ssd_plain,
                         mla_decode=ref.mla_decode_plain,
                         moe_grouped_gated=ref.grouped_gated_plain,
                         moe_grouped_mm=ref.grouped_mm_plain,
                         moe_combine=lambda yd, gate, slot_of, slot_tok=None:
                         ref.moe_combine_plain(yd, gate, slot_of),
                         moe_dispatch=lambda x, tok_of_slot, slot_valid, slot_of:
                         ref.moe_dispatch_plain(x, tok_of_slot, slot_valid))

MODES = ("serve", "train", "prefill", "decode")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """[..., K] -> contiguous [M, K] (a view when x is already contiguous)."""
    return x.reshape(-1, x.shape[-1])


@dataclass(frozen=True)
class PCtx:
    plain: bool = False                    # plain versions even on CUDA
    mode: str = "serve"                    # serve | train | prefill | decode
    pcfg: ParallelConfig = field(default_factory=ParallelConfig)
    mesh: Optional[Grid] = None            # the grid, or one device
    seq_len: Optional[int] = None          # the step's global sequence (megatron)

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.mesh is not None and self.mode == "serve":
            raise ValueError("a grid serves in mode 'prefill' or 'decode'")

    @property
    def strategy(self) -> str:
        """The layout the methods run: ``pcfg.strategy``, except decode on
        a grid, which runs the 1D layout (megatron's) over the model axes."""
        return "megatron" if self.mode == "decode" else self.pcfg.strategy

    @property
    def use_hecaton(self) -> bool:
        return self.mesh is not None and self.strategy == "hecaton"

    @property
    def use_megatron(self) -> bool:
        return self.mesh is not None and self.strategy == "megatron"

    @property
    def ax(self) -> Optional[shd.AxisInfo]:
        return shd.axis_info(self.mesh, self.strategy)

    @property
    def residual(self) -> str:
        """The residual layout (``config.RESIDUAL_LAYOUTS``); hecaton's
        tiling is token-sharded whatever it says, and decode forces
        ``"replicated"`` (one token cannot token-scatter)."""
        return "replicated" if self.mode == "decode" else self.pcfg.residual

    def global_seq_len(self) -> int:
        if self.seq_len is None:
            raise ValueError("a megatron PCtx needs the step's global seq_len")
        return self.seq_len

    @property
    def seq_sharded(self) -> bool:
        """Megatron: does the seq residual cut this step's sequence?"""
        return (self.use_megatron and self.residual == "seq"
                and shd.seq_shardable(self.ax, self.global_seq_len()))

    @property
    def data_shards(self) -> int:
        """How many ranks split the batch (the data axes)."""
        return 1 if self.mesh is None else self.ax.n_data

    @property
    def seq_shards(self) -> int:
        """How many ranks split a sequence: hecaton's token axis, megatron's
        model axis under the seq residual, else 1."""
        if self.use_hecaton:
            return self.mesh.size("mx")
        return self.mesh.size(MODEL) if self.seq_sharded else 1

    @property
    def comm_dtype(self) -> str:
        """The ring hops' wire dtype (``ParallelConfig.comm_dtype``)."""
        return self.pcfg.comm_dtype

    def grid_kwargs(self):
        """The options every grid op of ``core/hecaton.py`` takes."""
        return dict(overlap=self.pcfg.overlap, comm_dtype=self.comm_dtype, plain=self.plain)

    @property
    def ops(self):
        return _PLAIN if self.plain else ops

    @property
    def train(self) -> bool:
        return self.mode == "train"

    # ------------------------------------------------------------------
    # projections
    # ------------------------------------------------------------------
    def _proj(self, x: torch.Tensor, w: torch.Tensor, act: str = "none"):
        """act(x @ w) with the weight cast to x's dtype (an fp32 master in
        training: its gradient flows back through the cast)."""
        w = w.to(x.dtype)
        if ops.needs_grad(x, w):
            y = self.ops.tile_matmul(_rows(x), w, out_dtype=torch.float32 if act != "none"
                                     else None)
            if act != "none":                      # the epilogue, in fp32 then cast
                y = ref.EPILOGUE_ACTS[act](y).to(x.dtype)
        else:
            y = self.ops.matmul(_rows(x), w, act=act)
        return y.reshape(*x.shape[:-1], w.shape[1])

    def ffn(self, x: torch.Tensor, w1, w2, act: str, w1b=None):
        """FFN: act(x @ w1) [* (x @ w1b)] @ w2; ``act`` names the kernel's
        epilogue activation (``layers.EPILOGUE_ACT``)."""
        if self.use_hecaton:
            from repro_torch.core import hecaton as HEC
            return HEC.ffn_block(x, w1.to(x.dtype), w2.to(x.dtype),
                                 act_fn=ref.EPILOGUE_ACTS[act],
                                 w1b=None if w1b is None else w1b.to(x.dtype), **self.grid_kwargs())
        if self.use_megatron:
            return MEG.ffn(self, x, w1.to(x.dtype), w2.to(x.dtype), act,
                           None if w1b is None else w1b.to(x.dtype))
        x2 = _rows(x)
        if w1b is not None:
            h = self.ops.gated_matmul(x2, w1.to(x.dtype), w1b.to(x.dtype), act=act)
        else:
            h = _rows(self._proj(x2, w1, act))
        return self._proj(h, w2).reshape(*x.shape[:-1], w2.shape[1])

    def mixer_in(self, x: torch.Tensor, w: torch.Tensor, interior: bool = False):
        """Projection into a token mixer: the full sequence, hidden over the
        grid.  ``interior``: ``x`` is already inside the mixer (MLA's
        normed query latent), which the JAX package leaves GSPMD to
        re-lay on the grid; on one device it is the plain projection, and
        the grid refuses it (MLA on the grid is not ported)."""
        if interior and self.mesh is not None:
            raise NotImplementedError("MLA on the rank grid is not ported: mixer_in(interior="
                                      "True) has no grid layout here")
        if self.use_hecaton:
            from repro_torch.core import hecaton as HEC
            return HEC.mixer_in(x, w.to(x.dtype), **self.grid_kwargs())
        if self.use_megatron:
            return MEG.col_parallel(self, x, w.to(x.dtype))
        return self._proj(x, w)

    def mixer_in_many(self, x: torch.Tensor, *ws: torch.Tensor):
        """Several mixer-in projections of the same residual entry (Q/K/V):
        on the hecaton grid each is ``hecaton.mixer_in``; megatron's seq
        layout gathers the sequence once for all of them
        (``megatron.col_parallel_shared``)."""
        if self.use_megatron:
            return MEG.col_parallel_shared(self, x, tuple(w.to(x.dtype) for w in ws))
        return tuple(self.mixer_in(x, w) for w in ws)

    def mixer_out(self, y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Projection out of a token mixer (back to the canonical layout)."""
        if self.use_hecaton:
            from repro_torch.core import hecaton as HEC
            return HEC.mixer_out(y, w.to(y.dtype), **self.grid_kwargs())
        if self.use_megatron:
            return MEG.row_parallel(self, y, w.to(y.dtype))
        return self._proj(y, w)

    def small_proj(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Tiny projection (mamba dt/B/C) whose output is too narrow to tile:
        a plain matmul in x's dtype, as the JAX package leaves its einsum
        to XLA."""
        return torch.matmul(x, w.to(x.dtype))

    def lm_head(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Final projection to vocab logits; ``w`` is [d, V]: a contiguous
        matrix in serving, in training the untied head or the transposed
        view of the tied table, which the tile kernel reads in place.  On
        the hecaton grid one seq-scatter linear (tokens over ``my``, vocab
        over ``mx``); under megatron a column-parallel linear (the full
        sequence, vocab over ``model``)."""
        if self.use_hecaton:
            from repro_torch.core import hecaton as HEC
            return HEC.linear_seq_scatter(x, w.to(x.dtype), **self.grid_kwargs())
        if self.use_megatron:
            return MEG.col_parallel(self, x, w.to(x.dtype))
        return self._proj(x, w)

    # ------------------------------------------------------------------
    # embedding, head weight, norms (the collectives GSPMD inserted)
    # ------------------------------------------------------------------
    def embed(self, table: torch.Tensor, ids: torch.Tensor, compute_dtype) -> torch.Tensor:
        """Embedding lookup; on the grid the vocab-parallel ``embed_2d``
        (hecaton: ids [B, S/mx], table [V/mx, H/my] -> canonical [B, S/mx,
        H/my]; megatron: table [V/n, H] over ``model``, ids and output
        token-sharded under the seq layout, else whole)."""
        if self.mesh is not None:
            from repro_torch.core import hecaton as HEC
            if self.use_hecaton:
                return HEC.embed_2d(ids, table, compute_dtype=compute_dtype,
                                    **self.grid_kwargs())
            return HEC.embed_2d(ids, table, t_ax=MODEL, compute_dtype=compute_dtype,
                                seq_sharded=self.seq_sharded, **self.grid_kwargs())
        return L.apply_embed({"table": table}, ids, compute_dtype)

    def head_weight(self, table: torch.Tensor, dtype) -> torch.Tensor:
        """The tied head in ``dtype`` from this rank's table block.  Hecaton
        with the fused loss: [H, V/my] from the block [V/mx, H/my], the
        table gathered over ``my`` and ``mx`` and cut to this rank's vocab
        chunk of the loss's ``(None, my)`` layout (the reshard GSPMD does
        for ``table.T``).  Otherwise the block's transposed view: on one
        device the table's, under megatron [H, V/n] (``(model, None)``
        transposed is the head's ``(None, model)``), for hecaton's
        seq-scatter head [H/my, V/mx] (the non-fused loss, and serving)."""
        if not self.use_hecaton or not self.pcfg.fused_loss or not self.train:
            return table.to(dtype).t()
        full = table.to(dtype)
        for ax, dim in (("my", 1), ("mx", 0)):
            OV.log_route("head_weight", "all_gather", "bulk", ax, comm.axis_size(ax), full)
            full = comm.all_gather(full, ax, dim)
        n, j = self.mesh.size("my"), self.mesh.axis_index("my")
        v = full.shape[0] // n
        return full[j * v:(j + 1) * v].t()

    def norm(self, kind: str, params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
        """Pre-norm over the hidden dim.  On the grid the hidden dim is split
        over ``my``: the statistics are summed over ``my`` and this rank
        applies its slice of the scale."""
        if not self.use_hecaton or self.mesh.size("my") == 1:
            return L.apply_norm(kind, params, x, eps=eps)
        h_loc = x.shape[-1]
        j = self.mesh.axis_index("my")
        h_full = h_loc * self.mesh.size("my")
        scale = params["scale"][..., j * h_loc:(j + 1) * h_loc]
        xf = x.float()
        if kind == "rmsnorm":
            var = comm.psum(torch.sum(torch.square(xf), dim=-1, keepdim=True), "my") / h_full
            return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)
        if kind == "layernorm":
            mu = comm.psum(torch.sum(xf, dim=-1, keepdim=True), "my") / h_full
            var = comm.psum(torch.sum(torch.square(xf - mu), dim=-1, keepdim=True),
                            "my") / h_full
            bias = params["bias"][..., j * h_loc:(j + 1) * h_loc]
            return ((xf - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)
        raise KeyError(kind)

    # ------------------------------------------------------------------
    # attention layout
    # ------------------------------------------------------------------
    def attn_layout(self, n_heads: int, global_batch: int) -> shd.AttnLayout:
        a = self.ax
        if a is None:
            return shd.AttnLayout((), (), "single device")
        return shd.solve_attn_layout(a, n_heads, max(1, global_batch // a.n_data))

    def local_heads(self, cfg, q, k, v, global_batch: int):
        """q, k, v [B, S, heads*dh] out of the mixer-in projections -> this
        rank's [B, S, heads, dh] with the kv heads its q heads read.

        On the grid the projections come out hidden over the model axes
        ((mx, my), or megatron's ``model``: the same index), so rank r of
        them holds q heads r*nh/N .. (r+1)*nh/N - 1 ("heads fully sharded",
        the only attention layout ported).  When the kv heads split over
        the grid too, GQA stays local; otherwise K and V are gathered over
        the model axes and the kv heads of this rank's group kept (what
        GSPMD does for the ``repeat_kv`` constraint)."""
        dh, nh, nkv = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
        B, S = q.shape[:2]
        if self.mesh is None:
            return (q.reshape(B, S, nh, dh), k.reshape(B, S, nkv, dh),
                    v.reshape(B, S, nkv, dh))
        lay = self.attn_layout(nh, global_batch)
        if lay.note != "heads fully sharded":
            raise NotImplementedError(f"attention layout {lay.note!r} is not ported; the "
                                      "grid step takes heads that split over the model axes")
        maxes = self.ax.model_axes
        N = self.mesh.size(maxes)
        r = self.mesh.axis_index(maxes)
        nq, g = nh // N, nh // nkv
        q = q.reshape(B, S, nq, dh)
        if nkv % N == 0:
            return q, k.reshape(B, S, nkv // N, dh), v.reshape(B, S, nkv // N, dh)
        if g % nq:
            raise NotImplementedError(f"{nq} q heads per rank straddle kv groups of {g}")
        kv0 = r * nq // g

        def pick(t):
            for a in reversed(maxes):                # the inner axis first
                t = comm.all_gather(t, a, 2)
            return t.reshape(B, S, nkv, dh)[:, :, kv0:kv0 + 1]
        return q, pick(k), pick(v)

    # ------------------------------------------------------------------
    # attention
    # ------------------------------------------------------------------
    def attention(self, q, k, v, *, causal: bool = True,
                  q_offset: Optional[torch.Tensor] = None,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
        """q [B,nh,Sq,dk]; k [B,nkv,Sk,dk]; v [B,nkv,Sk,dv] (views of
        [B,S,heads,d]) -> [B,nh,Sq,dv]."""
        return self.ops.attention(q, k, v, causal=causal, q_offset=q_offset,
                                  kv_len=kv_len)

    def mla_decode(self, q_lat, q_rope, c_kv, k_rope, kv_len, scale: float) -> torch.Tensor:
        """MLA's absorbed decode attention, ``ref.mla_decode_plain``'s shapes
        (the kernel on the card): o_lat fp32 [B, nh, L].  One device only."""
        if self.mesh is not None:
            raise NotImplementedError("MLA on the rank grid is not ported")
        return self.ops.mla_decode(q_lat, q_rope, c_kv, k_rope, kv_len, scale)

    # ------------------------------------------------------------------
    # the Mamba2 scan
    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    # the MoE's experts (one device: ``models/mlp.apply_moe`` refuses a grid).
    # With a gradient the kernel path takes the differentiable custom ops
    # (``kernels/ops.py``); the plain path is PyTorch under autograd.
    # ------------------------------------------------------------------
    def moe_dispatch(self, x, tok_of_slot, slot_valid, slot_of):
        """The dispatch gather ``x[tok_of_slot] * slot_valid`` -> [E, C, H];
        its backward on the kernel path sums each token's slot gradients
        through the combine kernel (``slot_of``: each assignment's slot)."""
        return self.ops.moe_dispatch(x, tok_of_slot, slot_valid, slot_of)

    def moe_gated(self, xd, w1, w1b, act: str):
        """act(xd_e @ w1_e) * (xd_e @ w1b_e) for every expert e, one grouped
        launch (``ref.grouped_gated_plain``'s shapes)."""
        return self.ops.moe_grouped_gated(xd, w1, w1b, act=act)

    def moe_mm(self, h, w, act: str = "none"):
        """act(h_e @ w_e) for every expert e, one grouped launch
        (``ref.grouped_mm_plain``'s shapes)."""
        return self.ops.moe_grouped_mm(h, w, act=act)

    def moe_combine(self, yd, gate, slot_of, slot_tok=None):
        """Each token's gated sum of its experts' rows, in a fixed order
        (``ref.moe_combine_plain``'s shapes); ``slot_tok`` (the dispatch's
        slots) serves the kernel path's backward."""
        return self.ops.moe_combine(yd, gate, slot_of, slot_tok)

    def ssd(self, x, dt, A, B, C, *, chunk: int, init_state=None):
        """SSD chunked scan -> (y, fp32 final state); ``ref.ssd_plain``'s
        shapes (the kernel on the card)."""
        return self.ops.ssd(x, dt, A, B, C, chunk=chunk, init_state=init_state)

    # ------------------------------------------------------------------
    # residual-stream ops
    # ------------------------------------------------------------------
    def dropout(self, x: torch.Tensor, rate: float,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Inverted dropout in train mode; identity otherwise, or at rate 0,
        or without a generator.  On the grid each rank draws the mask of its
        own block."""
        if not self.train:
            return x
        return L.dropout(x, rate, generator)
