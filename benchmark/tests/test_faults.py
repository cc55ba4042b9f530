"""Each fault a cell can have, planted in the program underneath a run
rehearsed on the CPU, turns ``correct`` false under the cell's own limits:
a train step that returns its state unchanged, half of the batch left out
(the mean taken over the rest), an answer altered where it is produced.
(The exchange between chips has no place in these one-chip cells.) Two
faults that a median over all leaves or a judgement of agreeing clips
alone would miss fail their own numbers: a wrong backward at the first
stage's epilogue kernel (``update_stage``) and the
policy's decisions altered in all clips of a request but one
(``decisions``)."""

import functools

import pytest
import torch
import torch.nn.functional as F

import adamml_tpu_torch.ops.kernels.tpool_fused as tpool_fused
import adamml_tpu_torch.train.optim as optim
import adamml_tpu_torch.train.steps as steps
from benchmark.tests import tiny
from benchmark.tests.test_rehearsal import few_threads, rehearse  # noqa


def state_unchanged(monkeypatch):
    for cls in (optim.SGD, optim.Adam):
        step = cls.step

        def frozen(self, closure=None, _step=step):
            keep = [p.detach().clone() for g in self.param_groups
                    for p in g["params"]]
            _step(self, closure)
            with torch.no_grad():
                for p, k in zip((p for g in self.param_groups
                                 for p in g["params"]), keep):
                    p.copy_(k)

        monkeypatch.setattr(cls, "step", frozen)


def half_batch_loss(monkeypatch):
    def cross_entropy(logits, targets):
        n = logits.shape[0] // 2
        return F.cross_entropy(logits[:n], targets[:n].long())

    monkeypatch.setattr(steps, "cross_entropy", cross_entropy)


def stage1_backward(monkeypatch):
    """The backward of the epilogue after the first ResNet stage (the
    largest feature map: a quarter of the input's side) halves the
    gradient it hands on; the later stages' are right."""
    bwd = tpool_fused.fused_bn_add_relu_tpool_bwd
    side = tiny.REFERENCE["input_size"] // 4

    def wrong(y, ident, a, b, ct):
        dy, dident, da, db = bwd(y, ident, a, b, ct)
        if ct.shape[2] == side:
            dy, dident = dy * 0.5, dident * 0.5
        return dy, dident, da, db

    monkeypatch.setattr(tpool_fused, "fused_bn_add_relu_tpool_bwd", wrong)


def _eval_step_wrapped(monkeypatch, alter, alter_decisions=None):
    made = steps.make_adamml_eval_step

    def make(model, num_crops=1):
        inner = made(model, num_crops)

        @functools.wraps(inner)
        def step(state, inputs, target, seed):
            logits, decisions, loss = inner(state, inputs, target, seed)
            if alter_decisions is not None:
                decisions = alter_decisions(decisions.clone())
            return alter(logits.clone()), decisions, loss

        return step

    monkeypatch.setattr(steps, "make_adamml_eval_step", make)


def answer_altered(monkeypatch):
    def alter(logits):
        logits[0, 0] += 1.0 + logits.abs().max()
        return logits

    _eval_step_wrapped(monkeypatch, alter)


def half_batch_answers(monkeypatch):
    def alter(logits):
        n = logits.shape[0] // 2
        logits[n:] = logits[:n].mean(0)
        return logits

    _eval_step_wrapped(monkeypatch, alter)


def decisions_altered(monkeypatch):
    def alter_decisions(decisions):
        decisions[1:] = 1 - decisions[1:]
        return decisions

    _eval_step_wrapped(monkeypatch, lambda logits: logits, alter_decisions)


@pytest.mark.parametrize("cell,fault,number", [
    ("flagship.train-main", stage1_backward, "update_stage"),
    ("rgbflow.train-main", stage1_backward, "update_stage"),
    ("flagship.serve", decisions_altered, "decisions"),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_confined_fault_fails_its_own_number(monkeypatch, cell, fault,
                                               number):
    fault(monkeypatch)
    _, out, line = rehearse(cell, False)
    value, limit = line["compared"][number]
    assert line["correct"] is False and value > limit, line["compared"]


@pytest.mark.parametrize("cell,fault", [
    ("flagship.train-main", state_unchanged),
    ("flagship.train-main", half_batch_loss),
    ("rgbflow.train-main", state_unchanged),
    ("rgbflow.train-main", half_batch_loss),
    ("flagship.serve", answer_altered),
    ("flagship.serve", half_batch_answers),
], ids=lambda v: getattr(v, "__name__", v))
def test_a_fault_turns_correct_false(monkeypatch, cell, fault):
    fault(monkeypatch)
    _, out, line = rehearse(cell, False)
    assert line["correct"] is False, line["compared"]
