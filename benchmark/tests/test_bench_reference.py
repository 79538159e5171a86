"""The plain references (`benchmark/reference/`) on the CPU at a tiny size:
the serving reference's logits at chosen positions agree with a full
forward of the same weights (the port's, in float32, an independent
implementation of the same equations); the train reference's loss and
first gradients agree with autograd of the plain forward; the fp8
control departs from float32."""

import copy

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import weights as weights_mod
from benchmark.reference import train as ref_train
from benchmark.reference import transformer as ref

MISTRAL = {"vocab_size": 64, "d_model": 32, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
           "d_ff": 48, "max_seq": 64, "pos_emb": "rope", "norm": "rmsnorm", "norm_eps": 1e-6,
           "act": "swiglu", "use_bias": False, "tie_embeddings": False, "rope_theta": 1e6,
           "dtype": "float32", "param_dtype": "float32"}
GPT2 = {"vocab_size": 64, "d_model": 32, "n_layers": 2, "n_heads": 4, "d_ff": 64,
        "max_seq": 32, "pos_emb": "learned", "norm": "layernorm", "norm_eps": 1e-5,
        "act": "gelu", "use_bias": True, "tie_embeddings": True, "dtype": "float32",
        "param_dtype": "float32"}
OPT = {"learning_rate": 1e-3, "warmup_steps": 2, "total_steps": 10, "decay_steps": 10,
       "init_lr": 0.0, "end_lr": 1e-4, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
       "weight_decay": 0.1, "grad_clip": 1e9}


def _port_config(m):
    from ray_tpu_torch.models.transformer import TransformerConfig

    kw = {k: v for k, v in m.items() if k != "norm_eps"}
    kw["dtype"] = kw["param_dtype"] = torch.float32
    return TransformerConfig(**kw)


@pytest.mark.parametrize("m", [MISTRAL, GPT2], ids=["mistral", "gpt2"])
def test_serving_reference_matches_a_full_forward(m):
    from ray_tpu_torch.models.transformer import forward

    tree = weights_mod.make(m, 3, torch.device("cpu"))
    tokens = torch.randint(0, m["vocab_size"], (20,), generator=torch.Generator().manual_seed(0))
    full = forward(tree, tokens[None], _port_config(m))[0]
    rows = [3, 11, 19]
    got = ref.logits_at(tree, m, tokens.tolist(), rows)
    torch.testing.assert_close(got, full[rows], atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(ref.forward_all(tree, m, tokens), full, atol=2e-5, rtol=2e-5)


def test_greedy_gaps_are_zero_on_the_references_own_argmax():
    tree = weights_mod.make(MISTRAL, 4, torch.device("cpu"))
    prompt = list(range(1, 9))
    served, seq = [], list(prompt)
    for _ in range(5):
        nxt = int(ref.logits_at(tree, MISTRAL, seq, [len(seq) - 1])[0].argmax())
        served.append(nxt)
        seq.append(nxt)
    gaps = ref.greedy_gaps(tree, MISTRAL, prompt, served)
    assert gaps["max"] == 0.0 and gaps["n"] == 5
    wrong = served[:2] + [(served[2] + 1) % MISTRAL["vocab_size"]] + served[3:]
    assert ref.greedy_gaps(tree, MISTRAL, prompt, wrong)["max"] > 0.0


def test_train_reference_matches_autograd_of_the_plain_forward():
    tree = weights_mod.make(GPT2, 5, torch.device("cpu"))
    batch = torch.randint(0, 64, (3, 17), generator=torch.Generator().manual_seed(1))
    from ray_tpu_torch.models.transformer import forward

    leaves = {k: v.clone().requires_grad_(True) for k, v in ref.flat(tree).items()}
    logits = forward(ref.unflat(leaves), batch[:, :-1], _port_config(GPT2))
    loss = F.cross_entropy(logits.reshape(-1, 64), batch[:, 1:].reshape(-1))
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    out = ref_train.run_steps(copy.deepcopy(tree), GPT2, OPT, [batch])
    assert abs(out["loss"][0] - float(loss.detach())) < 1e-5
    for name, g in grads.items():
        assert abs(out["grad_norm"][name] - float(g.norm())) <= 1e-5 * max(1.0, float(g.norm()))


def test_train_reference_adamw_moves_by_the_schedule():
    tree = weights_mod.make(GPT2, 6, torch.device("cpu"))
    batch = torch.randint(0, 64, (2, 9), generator=torch.Generator().manual_seed(2))
    out = ref_train.run_steps(copy.deepcopy(tree), GPT2, OPT, [batch])
    # the warmup starts at 0: the first update moves nothing
    assert all(v == 0.0 for v in out["change_norm"].values())
    out = ref_train.run_steps(copy.deepcopy(tree), GPT2, OPT, [batch, batch])
    # the second moves every weight by lr(1) = 5e-4 a step (Adam's first update is +-1 an element)
    n = tree["wte"].numel()
    assert abs(out["change_norm"]["wte"] / (5e-4 * n ** 0.5) - 1.0) < 0.1
    assert ref_train.schedule(OPT, 0) == 0.0 and ref_train.schedule(OPT, 2) == OPT["learning_rate"]
    assert abs(ref_train.schedule(OPT, 10) - OPT["end_lr"]) < 1e-12


def test_fp8_control_departs_from_float32():
    tree = weights_mod.make(MISTRAL, 7, torch.device("cpu"))
    tokens = list(range(3, 23))
    f32 = ref.logits_at(tree, MISTRAL, tokens, [19])
    fp8 = ref.logits_at(tree, MISTRAL, tokens, [19], precision="fp8")
    err = float((f32 - fp8).abs().max() / f32.abs().max())
    assert 1e-3 < err < 0.5
    x = torch.linspace(-3, 3, 101)
    assert float((ref.round_fp8(x) - x).abs().max()) <= 3 / 448 * 32  # e4m3: 3 mantissa bits
