"""What the benchmark takes from the program under test (``repro_torch``,
under ``src/`` of the checkout): its model for a configuration, its
parameter layout, and its train and prefill steps. Nothing else of the
program is read; the program never sees the benchmark's files.

``model_config`` starts from the program's registered configuration of
``port_arch`` (which fixes the layout choices of the program alone, such
as the 4 padded experts) and sets every published size from the
benchmark's configuration file, then checks that they took.
"""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _import_path() -> None:
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def model_config(conf: dict, traffic: dict):
    """The program's ModelConfig for a configuration file and a mix."""
    _import_path()
    from repro_torch.configs import get_config
    base = get_config(conf["port_arch"])
    fields = dict(
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"],
        d_ff=conf["intermediate_size"], vocab=conf["vocab_size"],
        head_dim=conf.get("head_dim", 0), rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        tie_embeddings=bool(conf["tie_word_embeddings"]), dtype="bfloat16")
    if traffic["kind"] == "train":
        fields.update(microbatches=traffic["microbatches"],
                      remat=bool(traffic["remat"]))
    if conf.get("num_experts"):
        fe = conf["moe_intermediate_size"]
        if conf["shared_expert_intermediate_size"] % fe:
            raise ValueError("the shared expert is not a whole number of "
                             "routed experts' widths")
        fields["moe"] = dataclasses.replace(
            base.moe, n_experts=conf["num_experts"],
            top_k=conf["num_experts_per_tok"], d_ff_expert=fe,
            n_shared_experts=conf["shared_expert_intermediate_size"] // fe,
            capacity_factor=float(conf["moe_capacity_factor"]),
            group_size=conf["moe_group_size"],
            router_aux_weight=float(conf["router_aux_loss_coef"]))
    cfg = dataclasses.replace(base, **fields)
    if cfg.resolved_head_dim * cfg.n_heads != conf["hidden_size"] and \
            not conf.get("head_dim"):
        raise ValueError("head_dim does not follow from the hidden size")
    return cfg


def model(conf: dict, traffic: dict):
    _import_path()
    from repro_torch.models.model import Model
    return Model(model_config(conf, traffic))


def layout(m) -> list:
    """(path, shape, dtype) of every parameter leaf of the program."""
    from repro_torch.models.param import tree_paths
    return [(p, tuple(d.shape), d.dtype) for p, d in tree_paths(m.defs)]


def train_step(m, opt: dict):
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import train_step as ts
    cfg = AdamWConfig(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"],
                      eps=opt["eps"], weight_decay=opt["weight_decay"],
                      clip_norm=opt["clip_norm"],
                      warmup_steps=opt["warmup_steps"],
                      total_steps=opt["total_steps"],
                      min_lr_frac=opt["min_lr_frac"])
    return ts.make_train_step(m, cfg)


def init_opt(params):
    from repro_torch.optim import init_state
    return init_state(params)


def prefill_step(m):
    from repro_torch.train import serve_step
    return serve_step.make_prefill_step(m)
