"""What a cell runs: the system under test (the measured package's model
and train step, built as a configuration states) or, in its place, the
plain reference (the yardstick, and at a lower precision the control).

Every system is built from the benchmark's own seeded state_dict
(perfbench/weights.py) and has the same interface, so a traffic kind
drives any of them the same way:

  * inference: ``system(ims) -> output`` (NHWC, returns before the card
    finishes);
  * training: ``system.step(batch) -> loss`` (a 0-d tensor on the card),
    ``first_grads()`` (the gradient the optimizer took in its first step,
    by parameter name) and ``state()`` (parameters and BatchNorm
    statistics by name).

The measured package is imported inside these functions only, so that
the reference and the tests of the yardstick can run without it.
"""

from __future__ import annotations

import contextlib

import torch

from perfbench.reference import models as ref_models
from perfbench.reference import train as ref_train

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@contextlib.contextmanager
def float32_exact():
    """TF32 off for the reference's products and convolutions, restored
    after, so that the program keeps its own settings."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def build_program_model(cfg: dict, sd: dict, device):
    from qpwcnet_torch.models import build_flow_net, build_interpolator

    make = {"flow": build_flow_net,
            "interp": build_interpolator}[cfg["model"]]
    model = make(seed=0, device=device, dtype=DTYPES[cfg["dtype"]],
                 **cfg["program"])
    model.load_state_dict(sd, strict=True)
    return model


class ProgramInfer:
    """The measured model in eval mode under inference_mode, as the
    package's inference app runs it."""

    def __init__(self, cfg: dict, sd: dict, device):
        self.model = build_program_model(cfg, sd, device).eval()

    def __call__(self, ims):
        with torch.inference_mode():
            return self.model(ims)


class ProgramTrain:
    """The measured train step with the configuration's optimizer chain
    (NaN scrub -> AGC -> Adam: ``default_optimizer``, or
    ``create_interp_train_state`` for the interpolator)."""

    def __init__(self, cfg: dict, sd: dict, device):
        from qpwcnet_torch import train

        t = cfg["train"]
        self.model = build_program_model(cfg, sd, device)
        if cfg["model"] == "flow":
            self.opt = train.default_optimizer(
                self.model, t["learning_rate"], t["agc_clip"], t["agc_eps"])
            self.fn = train.make_flow_train_step(t["l2_gamma"])
        else:
            self.opt = train.create_interp_train_state(
                self.model, t["learning_rate"], t["agc_clip"], t["agc_eps"])
            self.fn = train.make_interp_train_step(t["l2_gamma"])

    def step(self, batch: dict):
        return self.fn(self.model, self.opt, batch)["loss"]

    def first_grads(self) -> dict:
        """Adam's first moment after one step is 0.1 g: the gradient it
        was given, after the scrub and AGC."""
        state = self.opt.adam.state
        return {k: state[p]["exp_avg"] / 0.1
                for k, p in self.model.named_parameters()}

    def state(self) -> dict:
        return {k: v.detach() for k, v in self.model.state_dict().items()}


class RefInfer:
    """The plain reference in eval mode, float32 with TF32 off, or with a
    convolution's operands rounded to ``precision``."""

    def __init__(self, cfg: dict, sd: dict, device,
                 precision: str = "float32"):
        self.model = ref_models.build(cfg, precision).to(device)
        self.model.load_state_dict(sd, strict=True)

    def __call__(self, ims):
        with torch.no_grad(), float32_exact():
            return self.model(ims)


class RefTrain:
    """The plain reference train step (perfbench/reference/train.py)."""

    def __init__(self, cfg: dict, sd: dict, device,
                 precision: str = "float32"):
        t = cfg["train"]
        self.model = ref_models.build(cfg, precision).to(device)
        self.model.load_state_dict(sd, strict=True)
        self.chain = ref_train.Chain(self.model, t["learning_rate"],
                                     t["agc_clip"], t["agc_eps"])
        self.l2 = t["l2_gamma"]
        self.grads0: dict = {}
        self.l2_terms: list[float] = []

    def step(self, batch: dict):
        with float32_exact():
            with torch.no_grad():
                self.l2_terms.append(
                    float(ref_train.l2_term(self.model, self.l2)))
            loss = ref_train.step(self.model, self.chain, batch, self.l2)
        if self.chain.t == 1:
            self.grads0 = self.chain.seen
        return torch.tensor(loss)

    def first_grads(self) -> dict:
        return self.grads0

    def state(self) -> dict:
        return {k: v.detach() for k, v in self.model.state_dict().items()}


def build(kind: str, cfg: dict, sd: dict, device, system: str):
    """kind 'infer' or 'train'; system 'program', or 'reference' /
    'control' (the reference in float32, or in the control's precision
    put in the program's place)."""
    if system == "program":
        cls = ProgramInfer if kind == "infer" else ProgramTrain
        return cls(cfg, sd, device)
    cls = RefInfer if kind == "infer" else RefTrain
    precision = cfg["control_precision"] if system == "control" else \
        "float32"
    return cls(cfg, sd, device, precision)
