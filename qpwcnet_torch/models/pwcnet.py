"""PWC-Net-family models (port of qpwcnet_tpu/models/pwcnet.py):
Encoder, Decoder, Flower, PWCFlowNet, PWCInterpolator, build_flow_net and
build_interpolator.

``forward`` keeps JAX's NHWC boundary: (B, H, W, 6) in, the final
(B, H, W, 2) float32 flow (PWCFlowNet) or (B, H, W, 3) float32 middle
frame (PWCInterpolator) out, or the 6 multiscale outputs, coarse to
fine, with ``multiscale=True``. Inside, tensors are logical NCHW in
channels_last memory (qpwcnet_torch/layout.py).

``quant`` (a ``quantize.QuantConfig``) quantizes every conv as in the JAX
models: 'qat' fake-quantizes them and, in train mode, updates the
activation ranges; 'int8' runs them in int8 arithmetic, the encoder
stages chaining QTensors and handing the decoder and flow stack
dequantized features. The fused stem and upconv kernels are float-only:
the builders refuse ``stem_stages`` (and ``build_flow_net``
``upconv_stages``) with ``quant``, and the Decoder runs its UpConv
modules under ``quant``, as JAX's does.

PWCFlowNet's eval forward on the card replays as one CUDA graph
(:class:`ForwardGraphs`): the first call of an input signature runs
eagerly, the second captures the forward, later ones copy the input in,
replay the graph and return a copy of its output. It engages by the
module's mode and its input alone: a CUDA tensor, eval mode, no
gradient, no ``spatial`` and no ``quant``, outside any tracer; every
other call runs the eager forward.

The forwards are spans of ``utils/tracing.py``: ``flow_net.forward`` or
``interp.forward``, holding ``encoder``, ``decoder`` and ``flower``;
``flower`` holds ``flower.l0`` (the FlowBlock), ``flower.l1`` ... (each
upsample and UpFlowBlock) and ``flower.out`` (the last upsample). A
replayed forward records ``flow_net.forward`` alone: the inner spans are
recorded when the graph is captured and not when it replays. The kernel
wrappers' ``launches.*`` counters count every forward: each replay adds
what its capture counted. The counters ``flow_net.graph_eager``,
``flow_net.graph_captures`` and ``flow_net.graph_replays`` say which way
each eligible call went.
"""

from __future__ import annotations

import collections
import math
import os
import threading
from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.nn as nn
from torch.utils._python_dispatch import _get_current_dispatch_mode

from qpwcnet_torch.layout import CHANNELS_LAST, cat_channels, nchw, nhwc
from qpwcnet_torch.models.blocks import (
    BatchNorm,
    DownConv,
    FlowBlock,
    FrameInterpolate,
    UpConv,
    UpFlowBlock,
    int8_mode,
)
from qpwcnet_torch.ops.cuda.stem_kernel import downconv_stage_trainable
from qpwcnet_torch.ops.cuda.upconv_kernel import upconv_stage_trainable
from qpwcnet_torch.ops.resize import avg_pool_2x, upsample2x_bilinear_nchw
from qpwcnet_torch.parallel.transport import use_mesh
from qpwcnet_torch.quantize.fake_quant import QuantConfig
from qpwcnet_torch.quantize.qlayers import QConv, QConvTranspose
from qpwcnet_torch.quantize.qtensor import dequantize
from qpwcnet_torch.utils import tracing

ENCODER_FILTERS = (16, 32, 64, 128, 256)
DECODER_FILTERS = (128, 64, 32, 16)

CvImpl = Union[str, Sequence[str]]


class Encoder(nn.Module):
    """Siamese 5-stage feature pyramid, strides 1/2..1/32, no normalizer.

    The first ``stem_stages`` stages run as one fused CUDA kernel each
    (ops/cuda/stem_kernel.py), reading the same parameters as the
    DownConv modules, with the unfused composition's gradients; on CPU
    tensors the forward is the unfused composition too, at any stage
    count. On the card the kernel is built for every width of
    ``ENCODER_FILTERS`` in float32 and bf16 (``STEM_CHANNELS``); a stage
    of another width raises at its launch.

    In int8 mode (``quant``) the stages chain QTensors, and the pyramid
    features are their dequantized values in ``dtype``.
    """

    def __init__(self, filters: Sequence[int] = ENCODER_FILTERS,
                 dtype: torch.dtype = torch.float32, stem_stages: int = 0,
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        if stem_stages and quant is not None:
            raise ValueError("stem_stages requires the float path (no "
                             "quant): the int8 chain keeps its own conv")
        self.dtype = dtype
        self.stem_stages = stem_stages
        self.chain_q = int8_mode(quant)
        chans = [3, *filters]
        self.stages = nn.ModuleList(
            DownConv(chans[i], chans[i + 1], dtype=dtype, quant=quant)
            for i in range(len(filters)))

    def forward(self, img: torch.Tensor) -> list[torch.Tensor]:
        """img: (B, 3, H, W) -> [img, 1/2, ..., 1/32] NCHW features."""
        with tracing.span("encoder"):
            feats = [img]
            f = img.to(self.dtype)
            for i, stage in enumerate(self.stages):
                if i < self.stem_stages:
                    f = nchw(downconv_stage_trainable(
                        nhwc(f).contiguous(), stage.params(), self.dtype))
                else:
                    f = stage(f, emit_qtensor=self.chain_q)
                feats.append(dequantize(f, self.dtype) if self.chain_q
                             else f)
        return feats


class Decoder(nn.Module):
    """4 UpConv stages with skip-concat [up, enc] against the encoder
    feature of matching scale.

    The last ``upconv_stages`` stages run as one fused CUDA kernel each
    (ops/cuda/upconv_kernel.py), reading the same parameters as the
    UpConv modules, with the unfused composition's gradients; on CPU
    tensors the forward is the unfused composition too, at any stage
    count. On the card the kernel is built for every width of
    ``DECODER_FILTERS`` in float32 and bf16 (``UPCONV_CHANNELS``); a
    stage of another width raises at its launch. Under ``quant`` every
    stage runs its (quantized) UpConv module, as in JAX.
    """

    def __init__(self, filters: Sequence[int] = DECODER_FILTERS,
                 enc_filters: Sequence[int] = ENCODER_FILTERS,
                 dtype: torch.dtype = torch.float32, upconv_stages: int = 0,
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        self.dtype = dtype
        self.upconv_stages = 0 if quant is not None else upconv_stages
        stages = []
        c = enc_filters[-1]
        for k, f in enumerate(filters):
            stages.append(UpConv(c, f, dtype=dtype, quant=quant))
            c = f + enc_filters[-2 - k]
        self.stages = nn.ModuleList(stages)

    def forward(self, encs: list[torch.Tensor]) -> list[torch.Tensor]:
        with tracing.span("decoder"):
            f = encs[-1]
            decs = []
            n = len(self.stages)
            for k, stage in enumerate(self.stages):
                if n - k <= self.upconv_stages:
                    f = nchw(upconv_stage_trainable(
                        nhwc(f.to(self.dtype)).contiguous(), stage.params(),
                        self.dtype))
                else:
                    f = stage(f)
                f = cat_channels([f, encs[-2 - k].to(f.dtype)])
                decs.append(f)
        return decs


class Flower(nn.Module):
    """FlowBlock at the coarsest scale, then num_levels x (2x upsample
    (x2.0) + UpFlowBlock), then a final 2x upsample (x2.0). Outputs
    num_levels + 2 flows, coarse to fine.

    cv_impl: one string for every level ('auto' | 'plain' | 'fused'),
    'fast' (fused at the finest UpFlowBlock only, 'auto' elsewhere), or a
    sequence of num_levels + 1 strings, coarsest first. spatial: the
    blocks' ``parallel.SpatialConfig`` when the model runs H-sharded.
    """

    def __init__(self, enc_ch: int = ENCODER_FILTERS[-1],
                 dec_ch: Sequence[int] = (256, 128, 64, 32),
                 dtype: torch.dtype = torch.float32,
                 cv_impl: CvImpl = "auto", head_scale: str = "diag",
                 residual: bool = False, spatial=None,
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        self.num_levels = len(dec_ch)
        self.cv_impl = cv_impl if isinstance(cv_impl, str) else tuple(cv_impl)
        self.flow_0 = FlowBlock(enc_ch, dtype=dtype,
                                cv_impl=self.impl_at(0),
                                head_scale=head_scale, spatial=spatial,
                                quant=quant)
        self.upflows = nn.ModuleList(
            UpFlowBlock(c, dtype=dtype, cv_impl=self.impl_at(i + 1),
                        head_scale=head_scale, residual=residual,
                        spatial=spatial, quant=quant)
            for i, c in enumerate(dec_ch))
        # the levels' span names, made once: a span costs no allocation
        self.level_spans = tuple(f"flower.l{i}"
                                 for i in range(self.num_levels + 1))

    def impl_at(self, i: int) -> str:
        if isinstance(self.cv_impl, tuple):
            if len(self.cv_impl) != self.num_levels + 1:
                raise ValueError(f"cv_impl needs {self.num_levels + 1} "
                                 f"entries, got {self.cv_impl}")
            return self.cv_impl[i]
        if self.cv_impl == "fast":
            return "fused" if i == self.num_levels else "auto"
        return self.cv_impl

    def forward(self, enc_prv, enc_nxt, decs_prv, decs_nxt):
        with tracing.span("flower"):
            with tracing.span(self.level_spans[0]):
                flo = self.flow_0(enc_prv, enc_nxt)
            flos = [flo]
            for i, upflow in enumerate(self.upflows):
                with tracing.span(self.level_spans[i + 1]):
                    flo_u = upsample2x_bilinear_nchw(flo, scale=2.0)
                    flo = upflow(decs_prv[i], decs_nxt[i], flo_u)
                flos.append(flo)
            with tracing.span("flower.out"):
                flos.append(upsample2x_bilinear_nchw(flo, scale=2.0))
        return flos


class _Graph(NamedTuple):
    """One captured forward: the graph, the static input it reads, the
    static output it writes (a tensor or a list of tensors) and the
    ``launches.*`` counts its capture made, which each replay adds."""
    graph: torch.cuda.CUDAGraph
    input: torch.Tensor
    output: Union[torch.Tensor, list]
    launches: dict


class ForwardGraphs:
    """A module's eval forward captured as CUDA graphs, one an input
    signature, at most ``SLOTS`` of them, the least recently used dropped
    first (each holds a private memory pool of about the forward's peak).

    ``run(forward, x, *args)``: the first call of a signature runs
    ``forward`` eagerly (its lazy set-up: library loads, kernel
    attributes, cuDNN's choice of algorithm); the second captures it into
    a static input and output; later calls copy ``x`` in, replay and
    return a clone of the output, which the next replay does not touch.
    A replay runs no Python of the forward, so it adds the kernel
    wrappers' ``launches.*`` counts that the capture made: the counters
    count the kernels each call launches, whichever way it ran.
    The signature is the input's shape, strides, dtype and device, the
    other arguments, the current stream (calls on two streams share no
    static buffer) and the settings that choose kernels (cuDNN's TF32,
    determinism and benchmark flags, the float32 matmul precision): a
    graph replays the kernels chosen at capture.

    A graph reads the module's parameters and buffers where they were at
    capture: copies into them in place (``load_state_dict``) reach it,
    tensors put in their place do not, so their owner calls :meth:`clear`.
    Copies and pickles of the owner start with no graph.
    """

    SLOTS = 4

    def __init__(self, name: str):
        self.name = name
        self._eager = f"{name}.graph_eager"
        self._captures = f"{name}.graph_captures"
        self._replays = f"{name}.graph_replays"
        self._lock = threading.Lock()
        self._entries: collections.OrderedDict = collections.OrderedDict()

    def __getstate__(self):
        return {"name": self.name}

    def __setstate__(self, state):
        self.__init__(state["name"])

    def __len__(self) -> int:
        return sum(g is not None for g in self._entries.values())

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def run(self, forward, x: torch.Tensor, *args):
        cudnn = torch.backends.cudnn
        key = (tuple(x.shape), x.stride(), x.dtype, x.device, args,
               torch.cuda.current_stream(x.device).cuda_stream,
               cudnn.allow_tf32, cudnn.deterministic, cudnn.benchmark,
               torch.get_float32_matmul_precision())
        with self._lock:
            seen = key in self._entries
            g = self._entries.pop(key, None)
            self._entries[key] = g
            if len(self._entries) > self.SLOTS:
                self._entries.popitem(last=False)
            if not seen:
                tracing.count(self._eager)
                return forward(x, *args)
            with torch.cuda.device(x.device):
                if g is None:
                    g = self._entries[key] = self._capture(forward, x, args)
                    tracing.count(self._captures)
                else:
                    g.input.copy_(x)
                    tracing.count(self._replays)
                    for name, n in g.launches.items():
                        tracing.count(name, n)
                g.graph.replay()
            out = g.output
            return ([t.clone() for t in out] if isinstance(out, list)
                    else out.clone())

    @staticmethod
    def _capture(forward, x, args) -> _Graph:
        # With a CUDA graph in the process, later torch.profiler sessions
        # lose kernel records (every other session its first one) when
        # CUPTI is torn down and set up again between sessions (H100,
        # torch 2.11, CUDA 12.8); torch.profiler turns the teardown off
        # the same way where torch.compile makes CUDA graphs.
        os.environ.setdefault("TEARDOWN_CUPTI", "0")
        # a plain tensor even under inference_mode, so that calls under
        # no_grad may copy into it too
        with torch.inference_mode(False):
            static = torch.empty_like(x)
        static.copy_(x)
        graph = torch.cuda.CUDAGraph()
        before = tracing.counts()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = forward(static, *args)
        launches = {k: n - before.get(k, 0)
                    for k, n in tracing.counts().items()
                    if k.startswith("launches.") and n != before.get(k, 0)}
        return _Graph(graph, static, out, launches)


class PWCFlowNet(nn.Module):
    """The optical-flow model.

    forward(inputs (B, H, W, 6)) -> the final (B, H, W, 2) float32 flow,
    or with multiscale=True the list of 6 flows at 1/32..1/1 (the JAX
    model's train=True output). Train/eval mode is the module's: in
    ``.train()`` BatchNorm uses and updates batch statistics.

    fuse_batch=True runs the siamese encoder/decoder once on the 2B stack
    [prv; nxt] (exact: the pyramid has no normalizer).

    spatial: a ``parallel.SpatialConfig``: the model runs H-sharded over
    its mesh's 'model' axis (inputs from ``parallel.shard_batch_spatial``,
    outputs sharded alike); forward makes the mesh active for every op.

    quant: a ``quantize.QuantConfig`` (module docstring).

    The eval forward of a CUDA input replays as a CUDA graph where
    :meth:`_graphable` allows (module docstring, :class:`ForwardGraphs`).
    ``.to()``, ``.cuda()``, ``.half()`` (``_apply``) drop the graphs;
    ``load_state_dict`` copies in place, which the graphs read.
    """

    def __init__(self, dtype: torch.dtype = torch.float32,
                 cv_impl: CvImpl = "auto", head_scale: str = "diag",
                 residual: bool = False, stem_stages: int = 0,
                 fuse_batch: bool = True, upconv_stages: int = 0,
                 spatial=None, quant: Optional[QuantConfig] = None):
        super().__init__()
        self.fuse_batch = fuse_batch
        self.spatial = spatial
        self.quant = quant
        self.encoder = Encoder(dtype=dtype, stem_stages=stem_stages,
                               quant=quant)
        self.decoder = Decoder(dtype=dtype, upconv_stages=upconv_stages,
                               quant=quant)
        self.flower = Flower(dtype=dtype, cv_impl=cv_impl,
                             head_scale=head_scale, residual=residual,
                             spatial=spatial, quant=quant)
        self.graphs = ForwardGraphs("flow_net")

    def forward(self, inputs: torch.Tensor, multiscale: bool = False):
        with tracing.span("flow_net.forward"):
            if self._graphable(inputs):
                return self.graphs.run(self._forward, inputs, multiscale)
            if self.spatial is None:
                return self._forward(inputs, multiscale)
            with use_mesh(self.spatial.mesh):
                return self._forward(inputs, multiscale)

    def _graphable(self, inputs) -> bool:
        """Whether this call may replay a CUDA graph: a plain CUDA tensor
        (no fake, functional or FX tracing stand-in) into the eval forward
        with gradients off, no H-sharded mesh (its NCCL halos) and no
        quantization, outside torch.compile and under no dispatch mode
        (export's fake tensors, the flop counter of
        ``utils/profiling.py:cost_analysis``), which must see the ops."""
        return (type(inputs) is torch.Tensor and inputs.is_cuda
                and not self.training
                and not torch.is_grad_enabled() and self.spatial is None
                and self.quant is None
                and not torch.compiler.is_compiling()
                and _get_current_dispatch_mode() is None)

    def _apply(self, fn, *args, **kwargs):
        self.graphs.clear()
        return super()._apply(fn, *args, **kwargs)

    def _forward(self, inputs: torch.Tensor, multiscale: bool):
        x = nchw(inputs)
        img_prv = x[:, :3].contiguous(memory_format=CHANNELS_LAST)
        img_nxt = x[:, 3:].contiguous(memory_format=CHANNELS_LAST)
        if self.fuse_batch:
            b = img_prv.shape[0]
            encs = self.encoder(torch.cat([img_prv, img_nxt], dim=0))
            decs = self.decoder(encs)
            encs_prv = [e[:b] for e in encs]
            encs_nxt = [e[b:] for e in encs]
            decs_prv = [d[:b] for d in decs]
            decs_nxt = [d[b:] for d in decs]
        else:
            encs_prv = self.encoder(img_prv)
            encs_nxt = self.encoder(img_nxt)
            decs_prv = self.decoder(encs_prv)
            decs_nxt = self.decoder(encs_nxt)
        flos = self.flower(encs_prv[-1], encs_nxt[-1], decs_prv, decs_nxt)
        flos = [nhwc(f.float()).contiguous() for f in flos]
        return flos if multiscale else flos[-1]


class PWCInterpolator(nn.Module):
    """The frame-interpolation model: the shared encoder and decoder, ONE
    Flower run in both directions, and the FrameInterpolate heads img_0
    (on the coarsest avg-pool image level) and img_1..img_4 (on the
    decoder features).

    forward(inputs (B, H, W, 6)) -> the final (B, H, W, 3) float32
    middle frame, or with multiscale=True the list of 6 images at
    1/32..1/1 (the JAX model's train=True output); return_flows=True
    also returns (flos_01, flos_10), the 6 multiscale flows of each
    direction, NHWC float32.

    fuse_batch=True runs the encoder and decoder once on the 2B stack
    [prv; nxt] and the Flower once on the 2B stack of both directions
    (rows [:B] flos_01 with the (nxt, prv) argument order, rows [B:]
    flos_10 with (prv, nxt)). That is exact in eval mode; in train mode
    the flow heads' BatchNorm statistics are taken over the joint 2B
    direction batch instead of per direction, as in the JAX model.

    quant: a ``quantize.QuantConfig`` (module docstring).
    """

    def __init__(self, dtype: torch.dtype = torch.float32,
                 cv_impl: CvImpl = "auto", head_scale: str = "diag",
                 residual: bool = False, stem_stages: int = 0,
                 fuse_batch: bool = True, upconv_stages: int = 0,
                 quant: Optional[QuantConfig] = None):
        super().__init__()
        self.fuse_batch = fuse_batch
        self.quant = quant
        self.encoder = Encoder(dtype=dtype, stem_stages=stem_stages,
                               quant=quant)
        self.decoder = Decoder(dtype=dtype, upconv_stages=upconv_stages,
                               quant=quant)
        self.flower = Flower(dtype=dtype, cv_impl=cv_impl,
                             head_scale=head_scale, residual=residual,
                             quant=quant)
        dec_ch = [f + e for f, e in zip(DECODER_FILTERS,
                                        ENCODER_FILTERS[-2::-1])]
        self.imgs = nn.ModuleList(
            [FrameInterpolate(3, up=False, dtype=dtype, quant=quant)]
            + [FrameInterpolate(c, up=True, dtype=dtype, quant=quant)
               for c in dec_ch])

    def forward(self, inputs: torch.Tensor, multiscale: bool = False,
                return_flows: bool = False):
        with tracing.span("interp.forward"):
            return self._forward(inputs, multiscale, return_flows)

    def _forward(self, inputs: torch.Tensor, multiscale: bool,
                 return_flows: bool):
        x = nchw(inputs)
        img_prv = x[:, :3].contiguous(memory_format=CHANNELS_LAST)
        img_nxt = x[:, 3:].contiguous(memory_format=CHANNELS_LAST)
        if self.fuse_batch:
            b = img_prv.shape[0]
            encs = self.encoder(torch.cat([img_prv, img_nxt], dim=0))
            decs = self.decoder(encs)
            decs_prv = [d[:b] for d in decs]
            decs_nxt = [d[b:] for d in decs]

            def swap(t):
                return torch.cat([t[b:], t[:b]], dim=0)

            flos = self.flower(swap(encs[-1]), encs[-1],
                               [swap(d) for d in decs], decs)
            flos_01 = [f[:b] for f in flos]
            flos_10 = [f[b:] for f in flos]
        else:
            encs_prv = self.encoder(img_prv)
            encs_nxt = self.encoder(img_nxt)
            decs_prv = self.decoder(encs_prv)
            decs_nxt = self.decoder(encs_nxt)
            # the reference's argument orders
            flos_01 = self.flower(encs_nxt[-1], encs_prv[-1], decs_nxt,
                                  decs_prv)
            flos_10 = self.flower(encs_prv[-1], encs_nxt[-1], decs_prv,
                                  decs_nxt)

        # Avg-pool image pyramid, n+1 levels deep: only its coarsest level
        # feeds img_0; the up heads are fed decoder features, as in the
        # reference.
        pyr_prv, pyr_nxt = inputs[..., :3], inputs[..., 3:]
        for _ in range(len(DECODER_FILTERS) + 1):
            pyr_prv, pyr_nxt = avg_pool_2x(pyr_prv), avg_pool_2x(pyr_nxt)
        img = self.imgs[0](nchw(pyr_prv), nchw(pyr_nxt), flos_01[0],
                           flos_10[0])
        imgs = [img]
        for i, head in enumerate(self.imgs[1:]):
            img_u = upsample2x_bilinear_nchw(img, scale=1.0)
            img = head(decs_prv[i], decs_nxt[i], flos_01[i + 1],
                       flos_10[i + 1], img_u)
            imgs.append(img)
        imgs.append(upsample2x_bilinear_nchw(img, scale=1.0))

        imgs = [nhwc(im.float()).contiguous() for im in imgs]
        out = imgs if multiscale else imgs[-1]
        if return_flows:
            return out, tuple([nhwc(f.float()).contiguous() for f in fl]
                              for fl in (flos_01, flos_10))
        return out


def _lecun_normal_(w: torch.Tensor, fan_in: int,
                   gen: torch.Generator) -> None:
    """Flax lecun_normal: truncated normal in [-2, 2] std-units, scaled to
    variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=gen)


def init_weights(model: nn.Module, seed: int, head_scale: str) -> None:
    """The init schemes of the JAX build functions, from a
    torch.Generator: lecun-normal kernels (the img_* heads' too), zero
    biases, BatchNorm scale 1 / bias 0 / mean 0 / var 1, and the of_flow
    kernel zero under 'diag' or normal(0.01) under 'unit'."""
    gen = torch.Generator().manual_seed(seed)
    for name, m in model.named_modules():
        if isinstance(m, QConv):
            o, i, kh, kw = m.weight.shape
            if name.endswith("of_flow"):
                with torch.no_grad():
                    if head_scale == "unit":
                        m.weight.normal_(0.0, 1e-2, generator=gen)
                    else:
                        m.weight.zero_()
            else:
                _lecun_normal_(m.weight, i * kh * kw, gen)
        elif isinstance(m, QConvTranspose):
            i, o, kh, kw = m.weight.shape
            _lecun_normal_(m.weight, i * kh * kw, gen)
        elif isinstance(m, BatchNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)


def build_flow_net(seed: int = 0, device: Union[str, torch.device] = "cuda",
                   dtype: torch.dtype = torch.float32,
                   cv_impl: CvImpl = "auto", stem_stages: int = 0,
                   head_scale: str = "diag", residual: bool = False,
                   fuse_batch: bool = True, upconv_stages: int = 0,
                   spatial=None,
                   quant: Optional[QuantConfig] = None) -> PWCFlowNet:
    """Construct a PWCFlowNet on ``device`` (the card unless the caller
    asks for the CPU) with float32 parameters drawn from ``seed``,
    computing in ``dtype``; returned in eval mode.

    spatial: a ``parallel.SpatialConfig`` for the H-sharded path (the
    parameters are the same with or without it). The fused stem and
    upconv kernels are not shard-aware and float-only, so
    ``stem_stages`` and ``upconv_stages`` refuse ``spatial`` and
    ``quant``, as JAX's build_flow_net does. quant: a
    ``quantize.QuantConfig``; its ranges start at 0 (with ``spatial`` too:
    the int8 convs exchange their halo rows as int8 codes)."""
    if (stem_stages or upconv_stages) and (
            quant is not None or spatial is not None):
        raise ValueError(
            "stem_stages and upconv_stages need the float path (no quant) "
            "and the unsharded model: the fused stem and upconv kernels "
            "are float-only and not H-shard-aware")
    model = PWCFlowNet(dtype=dtype, cv_impl=cv_impl, head_scale=head_scale,
                       residual=residual, stem_stages=stem_stages,
                       fuse_batch=fuse_batch, upconv_stages=upconv_stages,
                       spatial=spatial, quant=quant)
    init_weights(model, seed, head_scale)
    return model.to(device).eval()


def build_interpolator(seed: int = 0,
                       device: Union[str, torch.device] = "cuda",
                       dtype: torch.dtype = torch.float32,
                       cv_impl: CvImpl = "auto", head_scale: str = "diag",
                       residual: bool = False, fuse_batch: bool = True,
                       stem_stages: int = 0,
                       upconv_stages: int = 0,
                       quant: Optional[QuantConfig] = None
                       ) -> PWCInterpolator:
    """Construct a PWCInterpolator on ``device`` (the card unless the
    caller asks for the CPU) with float32 parameters drawn from ``seed``,
    computing in ``dtype``; returned in eval mode. (JAX's
    build_interpolator has no ``upconv_stages``; its module has the
    field, which ``quant`` turns off.) ``stem_stages`` refuses
    ``quant`` (the Encoder raises ValueError), as JAX's does."""
    model = PWCInterpolator(dtype=dtype, cv_impl=cv_impl,
                            head_scale=head_scale, residual=residual,
                            stem_stages=stem_stages, fuse_batch=fuse_batch,
                            upconv_stages=upconv_stages, quant=quant)
    init_weights(model, seed, head_scale)
    return model.to(device).eval()
