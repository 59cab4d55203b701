"""Long-context training (counterpart of
``examples/long_context_trainer.py``): causal self-attention at real
sequence lengths through the flash forward and backward kernels, on one
card.

A 2-block causal self-attention stack trains on the position-marker
retrieval task: each sequence carries one marked position whose token
identity is the label, so the readout must attend across almost the whole
context to answer (chance is 1/NUM_CLASSES). Batches are drawn on the
device from explicit ``torch.Generator``s, fresh every step, so train
accuracy is generalization; each epoch ends with a 4-batch fresh-data
accuracy.

Env: SEQ_LEN (default 2048), EMBED (128), HEADS (2, head dim 64), BATCH
(32), STEPS_PER_EPOCH (60), EPOCHS (8), NUM_CLASSES (16), CURRICULUM
("S:epochs" phases, comma-separated: train the retrieval circuit at a
short length first, then continue at SEQ_LEN with the same weights;
"2048:5" whenever SEQ_LEN > 2048, "" disables it). The stack has no
positional parameters, so the circuit transfers across lengths.

    python -m dcnn_tpu_torch.examples.long_context_trainer
    DEVICE_TYPE=cpu SEQ_LEN=128 python -m dcnn_tpu_torch.examples.long_context_trainer
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn import SequentialBuilder
from ..nn.attention_layer import MultiHeadAttentionLayer
from ..nn.residual import ResidualBlock
from ..ops.losses import softmax_cross_entropy
from ..optim import Adam
from ..train import create_train_state, make_train_step
from ..utils.env import get_env
from .common import device_of, setup

# the readout pools the last READOUT positions (a flatten at S=8k would be
# a 1M-wide dense); the marker lands anywhere in [0, S - MARGIN)
READOUT = 32
MARGIN = 64


def make_trunk(seq_len: int, embed: int, heads: int):
    """2 residual causal-attention blocks."""
    def attn_block(name: str) -> ResidualBlock:
        return ResidualBlock(
            layers=[MultiHeadAttentionLayer(num_heads=heads, causal=True,
                                            impl="flash", name=f"{name}_mha")],
            shortcut=[], activation="relu", name=name)

    return (SequentialBuilder("long_context_mha")
            .input((seq_len, embed))
            .add_layer(attn_block("attn0"))
            .add_layer(attn_block("attn1"))
            .build())


def make_head(embed: int, num_classes: int):
    return (SequentialBuilder("lc_head").input((embed,))
            .dense(num_classes, True, "cls").build())


class LongContextModel(nn.Module):
    """trunk -> mean over the last READOUT positions -> head."""

    name = "long_context_joint"

    def __init__(self, trunk, head):
        super().__init__()
        self.trunk, self.head = trunk, head

    def forward(self, x: torch.Tensor, generator=None) -> torch.Tensor:
        z = self.trunk(x, generator=generator)
        return self.head(z[:, -READOUT:, :].mean(dim=1), generator=generator)


def seeded(device, *words: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``words`` through numpy's
    SeedSequence."""
    state = np.random.SeedSequence(list(words)).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0] >> 1))


def make_device_batch(gen: torch.Generator, batch: int, seq_len: int,
                      embed: int, num_classes: int):
    """Position-marker retrieval, drawn on ``gen``'s device: token
    embeddings N(0, 0.3²); one position p < S - MARGIN carries the marker
    (channel 0) and the class on channels 1..num_classes, both at 4.0; the
    label (one-hot) is that class."""
    dev = gen.device
    x = torch.randn(batch, seq_len, embed, generator=gen, device=dev) * 0.3
    pos = torch.randint(0, seq_len - MARGIN, (batch,), generator=gen,
                        device=dev)
    cls = torch.randint(0, num_classes, (batch,), generator=gen, device=dev)
    at_marker = F.one_hot(pos, seq_len).float() * 4.0            # (B, S)
    payload = (F.one_hot(torch.zeros_like(cls), embed)
               + F.one_hot(1 + cls, embed)).float()              # (B, E)
    return (x + at_marker[:, :, None] * payload[:, None, :],
            F.one_hot(cls, num_classes).float())


def main() -> dict:
    cfg = setup("long_context")
    dev = device_of(cfg.device_type)
    S = int(get_env("SEQ_LEN", 2048))
    E = int(get_env("EMBED", 128))
    H = int(get_env("HEADS", 2))
    B = int(get_env("BATCH", 32))
    steps = int(get_env("STEPS_PER_EPOCH", 60))
    epochs = int(get_env("EPOCHS", 8))
    nc = int(get_env("NUM_CLASSES", 16))

    trunk, head = make_trunk(S, E, H), make_head(E, nc)
    trunk.init(generator=seeded("cpu", cfg.seed, 0), device=dev)
    head.init(generator=seeded("cpu", cfg.seed, 1), device=dev)
    joint = LongContextModel(trunk, head)
    opt = Adam(cfg.learning_rate)
    ts = create_train_state(joint, opt)
    step = make_train_step(joint, softmax_cross_entropy, opt)

    # length phases share the weights: the stack is shape-agnostic; each
    # length is its own captured step graph
    default_cur = "2048:5" if S > 2048 else ""
    phases = []
    for spec in filter(None, get_env("CURRICULUM", default_cur).split(",")):
        s_c, ep_c = spec.split(":")
        phases.append((int(s_c), int(ep_c)))
    phases.append((S, epochs))

    epochs_out = []
    for phase_i, (s_len, n_epochs) in enumerate(phases):
        # the phase index is in every seed, so a curriculum phase of
        # SEQ_LEN's length never replays batches
        data = seeded(dev, cfg.seed, phase_i, 98)
        t0 = time.perf_counter()
        x, y = make_device_batch(data, B, s_len, E, nc)
        loss, _ = step(ts, x, y, cfg.learning_rate)
        float(loss)
        print(f"first step: {time.perf_counter() - t0:.1f}s "
              f"(S={s_len} B={B} E={E} H={H})")
        for epoch in range(1, n_epochs + 1):
            data = seeded(dev, cfg.seed, phase_i, epoch)
            t0 = time.perf_counter()
            losses = []
            for _ in range(steps):
                x, y = make_device_batch(data, B, s_len, E, nc)
                losses.append(step(ts, x, y, cfg.learning_rate)[0])
            mean_loss = float(torch.stack(losses).mean())
            dt = time.perf_counter() - t0
            # a 4-batch fresh-data eval
            joint.eval()
            hits = 0
            with torch.no_grad():
                for j in range(4):
                    ex, ey = make_device_batch(
                        seeded(dev, cfg.seed, phase_i, 555 + epoch * 7 + j),
                        B, s_len, E, nc)
                    hits += int((joint(ex).argmax(-1)
                                 == ey.argmax(-1)).sum())
            acc = hits / (4 * B)
            tok_s = B * s_len * steps / dt
            print(f"[S={s_len}] epoch {epoch}: loss {mean_loss:.4f} "
                  f"acc {acc:.3f} (fresh data) | {dt / steps * 1e3:.1f} "
                  f"ms/step = {tok_s / 1e6:.2f}M tokens/s", flush=True)
            epochs_out.append({"seq_len": s_len, "epoch": epoch,
                               "loss": mean_loss, "acc": acc,
                               "ms_per_step": dt / steps * 1e3,
                               "tokens_per_s": tok_s})
    return {"final_acc": epochs_out[-1]["acc"], "epochs": epochs_out,
            "shape": {"B": B, "S": S, "E": E, "H": H, "D": E // H}}


if __name__ == "__main__":
    main()
