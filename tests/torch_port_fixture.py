"""JAX golden fixtures for the PyTorch port.

``tests/data/torch_port_tiny.npz`` holds a depth-(2, 2) HTSAT config (so a
shifted block, the SW-MSA mask and the shift-0 rule of the last layer all
run), its JAX params as numpy, a 2-clip input, a layer-0 ResiDual and the
JAX f32 outputs of quantize -> featurize -> ``encode_audio`` (double-FFN on).

``tests/data/torch_port_wide.npz`` holds a config with a C=1024 layer (layer
2: 8x8 tokens, one window a clip, 16 heads of 64), so the port runs it
through K5. It stores no weights: they are made from the config's ``seed``
in the reference ``state_dict`` layout (:func:`seeded_state_dict`) and reach
the JAX package through its ``convert_htsat_state_dict``. It holds the
config, the input, a layer-0 ResiDual (K=64) and the JAX f32 outputs.

``tests/data/torch_port_train.npz`` holds the tiny fixture's config and
params, two batches of two clips with labels, five class-text embeddings, a
layer-0 ResiDual and the JAX package's golden λ-training outputs: the loss
and the λ-gradient of ``make_zero_shot_step``'s loss on batch 0, λ and the
loss after each of three Adam steps (lr 0.01, batches 0, 1, 0) and the
``evaluate_zero_shot`` similarities of both batches with that λ; and the
loss and λ-gradient on batch 0 under AMP (``compute_dtype=bfloat16``).

``tests/data/torch_port_clap.npz`` holds the full CLAP at narrow widths
(the tiny fixture's HTSAT, each text tower with 2 layers of width 64,
vocab 1000, context 16) for each ``text_model_type`` (roberta, bert, bart,
transformer). It stores no weights: they are made from the config's
``seed`` in the reference ``state_dict`` layout and reach the JAX package
through its ``convert_clap_state_dict``. It holds the config, a 2-clip
input, each tower's token ids and masks, and the JAX f32 outputs of
``encode_text`` and ``clap_apply``, plus roberta's ``encode_text`` under
AMP (``compute_dtype=bfloat16``).

``tests/data/torch_port_pann.npz`` holds two PANN towers at full width
(Cnn14 on a waveform, Cnn6 with ``aff_2d`` fusion on a fusion input) with
their projections, and ``tests/data/torch_port_fusion.npz`` the tiny
fixture's HTSAT with each of the seven fusion types. Neither stores weights:
they come from the seed in the reference ``state_dict`` layout
(:func:`seeded_state_dict`) and reach the JAX package through its
``convert_pann_state_dict`` / ``convert_htsat_state_dict`` and, for the
fusion keys neither maps, :func:`jax_fusion_params`. Each holds the config,
the inputs (a 0.5 s waveform; a fusion batch ``mel_fusion [2, 4, T, F]``
with ``longer`` = [True, False]) and the JAX f32 outputs of
``encode_audio``.

``tests/data/torch_port_vision.npz`` holds two narrow CLIPs (a ModifiedResNet
and a quick-GELU ViT, each with a 2-layer CLIP text tower of width 64). It
stores no weights: the JAX pytree's leaf paths and shapes, values from the
seed (:func:`seeded_tree_leaves`), reach the port through its
``models/convert.py::clip_state_dict``. It holds NHWC images, CLIP tokens
and the JAX f32 outputs of ``clip_apply``.

``chip_smoke.py`` runs the port on the card against all seven without
importing JAX; ``tests/test_torch_htsat.py``,
``tests/test_torch_wide_attention.py``, ``tests/test_torch_train_residual.py``
and ``tests/test_torch_clap.py`` regenerate them and compare with the
committed files, so they cannot drift.

Regenerate with ``python -m tests.torch_port_fixture [tiny|wide|train|clap|
pann|fusion|vision ...]`` from the repo root (all seven without an argument).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np

PATH = Path(__file__).with_name("data") / "torch_port_tiny.npz"
AUDIO_KW = dict(spec_size=64, mel_bins=16, embed_dim=32, depths=(2, 2), num_heads=(2, 4),
                clip_samples=24000, num_classes=17)
CLAP_KW = dict(embed_dim=64, joint_embed_shape=32)
OUTPUT_KEYS = ("embedding", "clipwise_output", "framewise_output", "fine_grained_embedding",
               "normalized")

TRAIN_PATH = PATH.with_name("torch_port_train.npz")
TRAIN_CLASSES = 5
TRAIN_LR = 0.01
TRAIN_STEPS = (0, 1, 0)  # the batch of each Adam step
TRAIN_OUTPUT_KEYS = ("loss", "grad", "lam", "step_loss", "sims")
TRAIN_AMP_KEYS = ("loss_bf16", "grad_bf16")  # batch 0 under AMP

WIDE_PATH = PATH.with_name("torch_port_wide.npz")
WIDE_AUDIO_KW = dict(spec_size=128, mel_bins=32, embed_dim=256, depths=(1, 1, 2),
                     num_heads=(4, 8, 16), clip_samples=24000, num_classes=17)
WIDE_CLAP_KW = dict(embed_dim=1024, joint_embed_shape=32)
WIDE_SEED = 0
WIDE_K = 64  # ResiDual components at layer 0 (C=256)
# fine_grained_embedding ([2, 1024, 1024] here) is left out to keep the file small
WIDE_OUTPUT_KEYS = ("embedding", "clipwise_output", "framewise_output", "normalized")


CLAP_PATH = PATH.with_name("torch_port_clap.npz")
CLAP_SEED = 0
CLAP_CONTEXT = 16
CLAP_TEXT_KW = {
    "roberta": dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                    intermediate_size=256, max_position_embeddings=CLAP_CONTEXT + 2),
    "bert": dict(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4,
                 intermediate_size=256, max_position_embeddings=CLAP_CONTEXT, type_vocab_size=2,
                 pad_token_id=0, style="bert"),
    "bart": dict(vocab_size=1000, d_model=64, num_layers=2, num_heads=4, ffn_dim=256,
                 max_position_embeddings=CLAP_CONTEXT),
    "transformer": dict(vocab_size=1000, width=64, heads=4, layers=2,
                        context_length=CLAP_CONTEXT),
}
CLAP_APPLY_KEYS = ("audio_features", "text_features", "audio_features_mlp",
                   "text_features_mlp", "logit_scale_a", "logit_scale_t")


def _flatten(tree, prefix: str, out: dict) -> dict:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    elif tree is not None:
        out[prefix] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    """Inverse of :func:`_flatten`: path keys back to nested dicts, digit
    keys to lists."""
    root: dict = {}
    for path, leaf in flat.items():
        node = root
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [listify(node[str(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def jax_config():
    from audio_residual_tpu.models import clap
    from audio_residual_tpu.models.htsat import HTSATConfig

    from .tiny import TINY_TEXT

    return clap.CLAPConfig(audio=HTSATConfig(**AUDIO_KW), text=TINY_TEXT, **CLAP_KW)


@functools.lru_cache(maxsize=1)
def jax_params() -> dict:
    """The full JAX CLAP params of the fixture's config (text tower too)."""
    import jax

    from audio_residual_tpu.models import clap

    return clap.init_clap_params(jax.random.PRNGKey(0), jax_config())


def build() -> dict[str, np.ndarray]:
    """The fixture's arrays: ``config``, ``wav``, ``residual/*``,
    ``param/<pytree path>`` and ``out/<key>``."""
    import jax
    import jax.numpy as jnp

    from audio_residual_tpu.data.featurize import featurize_batch
    from audio_residual_tpu.models import clap
    from audio_residual_tpu.ops.quantize import quantize_roundtrip
    from audio_residual_tpu.residual.module import init_residual_params

    cfg = jax_config()
    params = jax_params()
    audio = {"audio_branch": params["audio_branch"],
             "audio_projection": params["audio_projection"]}
    rng = np.random.default_rng(0)
    wav = (rng.standard_normal((2, AUDIO_KW["clip_samples"] // 2)) * 0.1).astype(np.float32)
    c = AUDIO_KW["embed_dim"]
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    res = init_residual_params(q, rng.standard_normal(c).astype(np.float32) * 0.01)
    res["lam"] = jnp.asarray((1 + 0.1 * rng.standard_normal(c)).astype(np.float32))
    batch = featurize_batch(quantize_roundtrip(jnp.asarray(wav)), cfg.audio.clip_samples)
    out = clap.encode_audio(params, batch, cfg, residual={0: res}, double_ffn_compat=True)
    arrays = {
        "config": np.asarray(json.dumps({"audio": AUDIO_KW, **CLAP_KW})),
        "wav": wav,
        **_flatten({k: np.asarray(v) for k, v in res.items()}, "residual", {}),
        **_flatten(jax.tree.map(np.asarray, audio), "param", {}),
    }
    arrays.update({f"out/{k}": np.asarray(out[k]) for k in OUTPUT_KEYS})
    return arrays


def seeded_state_dict(shapes: dict[str, tuple], seed: int) -> dict[str, np.ndarray]:
    """Random weights in the reference ``state_dict`` layout, one array per
    key in the order given: LN/BN scales near 1, running variances above 1,
    biases and relative-position tables at 0.02, weight matrices and
    convolutions at ``1/sqrt(fan_in)``."""
    rng = np.random.default_rng(seed)
    sd = {}
    for key, shape in shapes.items():
        z = rng.standard_normal(shape)
        if key.endswith("running_var"):
            v = 1 + 0.1 * np.abs(z)
        elif len(shape) == 1 and key.endswith(".weight"):
            v = 1 + 0.1 * z
        elif len(shape) == 1 or key.endswith("relative_position_bias_table"):
            v = 0.02 * z
        else:
            v = z / np.sqrt(np.prod(shape[1:]))
        sd[key] = np.asarray(v, dtype=np.float32)
    return sd


def _config(arrays: dict) -> tuple[dict, dict, int | None]:
    """``(audio kwargs, CLAP kwargs, weight seed or None)`` of a fixture."""
    cfg = json.loads(str(arrays["config"]))
    audio = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.pop("audio").items()}
    seed = cfg.pop("seed", None)
    return audio, cfg, seed


def _port_model(audio_kw: dict, clap_kw: dict, device):
    from audio_residual_tpu_torch.models import clap, htsat

    return clap.build_clap_audio(clap.CLAPConfig(audio=htsat.HTSATConfig(**audio_kw), **clap_kw),
                                 device=device)


def _seeded_weights(model, seed: int) -> dict[str, np.ndarray]:
    return seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()}, seed)


def build_wide() -> dict[str, np.ndarray]:
    """The wide fixture's arrays: ``config`` (with the weight ``seed``),
    ``wav``, ``residual/*`` and ``out/<key>``."""
    import jax.numpy as jnp

    from audio_residual_tpu.data.featurize import featurize_batch
    from audio_residual_tpu.models import clap, convert
    from audio_residual_tpu.models.htsat import HTSATConfig
    from audio_residual_tpu.ops.quantize import quantize_roundtrip
    from audio_residual_tpu.residual.module import init_residual_params

    from .tiny import TINY_TEXT

    sd = _seeded_weights(_port_model(WIDE_AUDIO_KW, WIDE_CLAP_KW, "cpu"), WIDE_SEED)
    params = {
        "audio_branch": convert.convert_htsat_state_dict(sd, "audio_branch.",
                                                         WIDE_AUDIO_KW["depths"]),
        "audio_projection": {
            f"fc{i}": {"kernel": sd[f"audio_projection.{j}.weight"].T,
                       "bias": sd[f"audio_projection.{j}.bias"]}
            for i, j in ((1, 0), (2, 2))
        },
    }
    cfg = clap.CLAPConfig(audio=HTSATConfig(**WIDE_AUDIO_KW), text=TINY_TEXT, **WIDE_CLAP_KW)
    rng = np.random.default_rng(WIDE_SEED)
    wav = (rng.standard_normal((2, WIDE_AUDIO_KW["clip_samples"] // 2)) * 0.1).astype(np.float32)
    c = WIDE_AUDIO_KW["embed_dim"]
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    res = init_residual_params(q, rng.standard_normal(c).astype(np.float32) * 0.01, WIDE_K)
    res["lam"] = jnp.asarray((1 + 0.1 * rng.standard_normal(WIDE_K)).astype(np.float32))
    batch = featurize_batch(quantize_roundtrip(jnp.asarray(wav)), cfg.audio.clip_samples)
    out = clap.encode_audio(params, batch, cfg, residual={0: res}, double_ffn_compat=True)
    arrays = {
        "config": np.asarray(json.dumps({"audio": WIDE_AUDIO_KW, **WIDE_CLAP_KW,
                                         "seed": WIDE_SEED})),
        "wav": wav,
        **_flatten({k: np.asarray(v) for k, v in res.items()}, "residual", {}),
    }
    arrays.update({f"out/{k}": np.asarray(out[k]) for k in WIDE_OUTPUT_KEYS})
    return arrays


def load(path: Path = PATH) -> dict[str, np.ndarray]:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def output_keys(arrays: dict) -> list[str]:
    return [k[len("out/"):] for k in arrays if k.startswith("out/")]


def _port_with_residual(arrays: dict, device):
    """The port's model of a fixture (params through the weight bridge, or
    from the seed) and its layer-0 ResiDual, on ``device``."""
    import torch

    from audio_residual_tpu_torch.models.convert import load_jax_params

    audio_kw, clap_kw, seed = _config(arrays)
    model = _port_model(audio_kw, clap_kw, device)
    if seed is None:
        load_jax_params(model, _unflatten(
            {k[len("param/"):]: v for k, v in arrays.items() if k.startswith("param/")}))
    else:
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in _seeded_weights(model, seed).items()})
    dev = model.audio_branch.norm.weight.device
    residual = {k[len("residual/"):]: torch.tensor(v).to(dev)
                for k, v in arrays.items() if k.startswith("residual/")}
    return model, residual


def run_port(arrays: dict, device, compute_dtype=None) -> dict[str, np.ndarray]:
    """The port's outputs on a fixture's input: params loaded through the
    weight bridge (tiny) or made from the seed (wide), quantize ->
    featurize -> ``encode_audio``. Imports torch and the port only, so it
    runs where JAX is absent."""
    import torch

    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models import clap
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip

    model, residual = _port_with_residual(arrays, device)
    wav = torch.tensor(arrays["wav"]).to(residual["basis"].device)
    batch = featurize_batch(quantize_roundtrip(wav), model.cfg.audio.clip_samples)
    out = clap.encode_audio(model, batch, residual={0: residual}, double_ffn_compat=True,
                            compute_dtype=compute_dtype)
    return {k: out[k].float().cpu().numpy() for k in output_keys(arrays)}


def train_inputs() -> dict[str, np.ndarray]:
    """The training fixture's seeded inputs: ``wav [2 batches, 2, T]``,
    ``labels [2, 2]``, unit ``text [5, D]`` and the ResiDual (QR basis,
    K = C)."""
    rng = np.random.default_rng(9)
    c, t = AUDIO_KW["embed_dim"], AUDIO_KW["clip_samples"] // 2
    text = rng.standard_normal((TRAIN_CLASSES, CLAP_KW["joint_embed_shape"]))
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    return {
        "wav": (rng.standard_normal((2, 2, t)) * 0.1).astype(np.float32),
        "labels": rng.integers(0, TRAIN_CLASSES, (2, 2)),
        "text": (text / np.linalg.norm(text, axis=-1, keepdims=True)).astype(np.float32),
        "residual/basis": q.astype(np.float32),
        "residual/mean": (rng.standard_normal(c) * 0.01).astype(np.float32),
        "residual/lam": (1 + 0.1 * rng.standard_normal(c)).astype(np.float32),
    }


def build_train() -> dict[str, np.ndarray]:
    """The training fixture's arrays: ``config``, the inputs of
    :func:`train_inputs`, ``param/<pytree path>`` and ``out/<key>``."""
    import jax
    import jax.numpy as jnp
    import optax

    from audio_residual_tpu.training import train_residual as jtr

    cfg = jax_config()
    params = jax_params()
    inputs = train_inputs()
    residual = {0: {k: jnp.asarray(inputs[f"residual/{k}"]) for k in ("basis", "mean", "lam")}}
    lam, frozen = jtr._split_residual(residual)
    optimizer = optax.adam(TRAIN_LR)
    step, loss_fn = jtr.make_zero_shot_step(params, cfg, jnp.asarray(inputs["text"]), frozen,
                                            optimizer, max_len=cfg.audio.clip_samples)
    wav, labels = jnp.asarray(inputs["wav"]), jnp.asarray(inputs["labels"])
    (loss, _), grad = jax.value_and_grad(loss_fn, has_aux=True)(lam, wav[0], labels[0])
    _, amp_loss_fn = jtr.make_zero_shot_step(params, cfg, jnp.asarray(inputs["text"]), frozen,
                                             optimizer, max_len=cfg.audio.clip_samples,
                                             compute_dtype=jnp.bfloat16)
    (loss16, _), grad16 = jax.value_and_grad(amp_loss_fn, has_aux=True)(lam, wav[0], labels[0])
    opt_state = optimizer.init(lam)
    step_loss = []
    for b in TRAIN_STEPS:
        lam, opt_state, l, _ = step(lam, opt_state, wav[b], labels[b])
        step_loss.append(float(l))
    _, _, sims = jtr.evaluate_zero_shot(params, cfg, zip(inputs["wav"], inputs["labels"]),
                                        jnp.asarray(inputs["text"]),
                                        residual=jtr._merge_residual(lam, frozen),
                                        max_len=cfg.audio.clip_samples)
    audio = {"audio_branch": params["audio_branch"],
             "audio_projection": params["audio_projection"]}
    return {
        "config": np.asarray(json.dumps({"audio": AUDIO_KW, **CLAP_KW})),
        **inputs,
        **_flatten(jax.tree.map(np.asarray, audio), "param", {}),
        "out/loss": np.asarray(loss),
        "out/grad": np.asarray(grad[0]),
        "out/lam": np.asarray(lam[0]),
        "out/step_loss": np.asarray(step_loss, dtype=np.float32),
        "out/sims": np.asarray(sims),
        "out/loss_bf16": np.asarray(loss16),
        "out/grad_bf16": np.asarray(grad16[0]),
    }


def run_port_train(arrays: dict, device, compute_dtype=None) -> dict[str, np.ndarray]:
    """The port's counterpart of :func:`build_train`'s outputs: its
    ``make_zero_shot_step`` (loss, λ-gradient, three Adam steps) and
    ``evaluate_zero_shot``. Imports torch and the port only."""
    import torch

    from audio_residual_tpu_torch.training import train_residual as ttr

    model, residual = _port_with_residual(arrays, device)
    dev = residual["basis"].device
    lam, frozen = ttr._split_residual({0: residual})
    optimizer = ttr.adam(lam, TRAIN_LR)
    step, loss_fn = ttr.make_zero_shot_step(model, arrays["text"], frozen, optimizer,
                                            max_len=model.cfg.audio.clip_samples,
                                            compute_dtype=compute_dtype)
    wav = torch.tensor(arrays["wav"], device=dev)
    labels = torch.tensor(arrays["labels"], device=dev)
    loss, _ = loss_fn(lam, wav[0], labels[0])
    (grad,) = torch.autograd.grad(loss, [lam[0]])
    step_loss = [float(step(lam, wav[b], labels[b])[0]) for b in TRAIN_STEPS]
    _, _, sims = ttr.evaluate_zero_shot(model, zip(wav, labels), arrays["text"],
                                        residual=ttr._merge_residual(lam, frozen),
                                        max_len=model.cfg.audio.clip_samples)
    return {"loss": np.float32(loss.detach().cpu()), "grad": grad.cpu().numpy(),
            "lam": lam[0].detach().cpu().numpy(),
            "step_loss": np.asarray(step_loss, dtype=np.float32), "sims": sims}


def run_port_train_amp(arrays: dict, device) -> dict[str, np.ndarray]:
    """The port's counterpart of the AMP outputs of :func:`build_train`: the
    loss and λ-gradient of its ``make_zero_shot_step`` on batch 0 under
    ``compute_dtype=bfloat16``."""
    import torch

    from audio_residual_tpu_torch.training import train_residual as ttr

    model, residual = _port_with_residual(arrays, device)
    dev = residual["basis"].device
    lam, frozen = ttr._split_residual({0: residual})
    _, loss_fn = ttr.make_zero_shot_step(model, arrays["text"], frozen, ttr.adam(lam, TRAIN_LR),
                                         max_len=model.cfg.audio.clip_samples,
                                         compute_dtype=torch.bfloat16)
    loss, _ = loss_fn(lam, torch.tensor(arrays["wav"][0], device=dev),
                      torch.tensor(arrays["labels"][0], device=dev))
    (grad,) = torch.autograd.grad(loss, [lam[0]])
    return {"loss_bf16": np.float32(loss.detach().cpu()), "grad_bf16": grad.cpu().numpy()}


def expected_launches(cfg, *, train: bool = False) -> dict[str, int]:
    """The kernel launches of one untapped forward of the port's HTSAT with
    config ``cfg``, per wrapper, by the JAX package's dispatch
    (``audio_residual_tpu/models/htsat.py:380-384,423-437``): K1 once; a
    training block with drop-path (``train and dpr > 0``) one window
    attention; any other block K4, or the split plan's attention and K3
    where a window covers the image; the attention is K5 from C >=
    ``WIDE_MIN_C``, where K4's wrapper takes the split plan too. Imports
    the port only."""
    from audio_residual_tpu_torch.models.htsat import drop_path_rates
    from audio_residual_tpu_torch.ops.cuda.window_attention import WIDE_MIN_C

    counts = dict.fromkeys(("fused_logmel", "fused_swin_block", "fused_window_attention",
                            "fused_residual_ffn", "wide_window_attention"), 0)
    counts["fused_logmel"] = 1
    dpr = drop_path_rates(cfg)
    k = 0
    for i, depth in enumerate(cfg.depths):
        h, w = cfg.layer_resolution(i)
        window = min(cfg.window_size, h, w)
        wide = cfg.layer_dim(i) >= WIDE_MIN_C
        attention = "wide_window_attention" if wide else "fused_window_attention"
        for _ in range(depth):
            if train and dpr[k] > 0.0:
                counts[attention] += 1
            elif (h // window) * (w // window) == 1 or wide:
                counts[attention] += 1
                counts["fused_residual_ffn"] += 1
            else:
                counts["fused_swin_block"] += 1
            k += 1
    return counts


def text_inputs(tmodel: str, batch: int = 4, seed: int = 5) -> dict[str, np.ndarray]:
    """``input_ids`` and ``attention_mask`` ``[batch, CLAP_CONTEXT]`` of a
    tower's token rules, rows of lengths from 3 to the context: HF towers
    ``<s> ... </s>`` then padding (pad 1; bert pad 0), the CLIP tower SOT
    ... EOT (the vocab's two largest ids, EOT the row's argmax) then zeros."""
    rng = np.random.default_rng(seed)
    vocab = CLAP_TEXT_KW[tmodel]["vocab_size"]
    lengths = np.linspace(3, CLAP_CONTEXT, batch).astype(int)
    if tmodel == "transformer":
        bos, eos, pad = vocab - 2, vocab - 1, 0
    else:
        bos, eos, pad = (101, 102, 0) if tmodel == "bert" else (0, 2, 1)
    ids = np.full((batch, CLAP_CONTEXT), pad, np.int64)
    mask = np.zeros((batch, CLAP_CONTEXT), np.int64)
    for i, n in enumerate(lengths):
        ids[i, :n] = [bos, *rng.integers(4, vocab - 2, n - 2), eos]
        mask[i, :n] = 1
    return {"input_ids": ids, "attention_mask": mask}


def port_clap_config(tmodel: str):
    """The port's CLAPConfig of the CLAP fixture's ``tmodel``."""
    from audio_residual_tpu_torch.models import bart, clap, clip_text, htsat, roberta

    text_cls = {"roberta": roberta.RobertaConfig, "bert": roberta.RobertaConfig,
                "bart": bart.BartConfig, "transformer": clip_text.ClipTextConfig}[tmodel]
    return clap.CLAPConfig(audio=htsat.HTSATConfig(**AUDIO_KW),
                           text=text_cls(**CLAP_TEXT_KW[tmodel]), text_model_type=tmodel,
                           context_length=CLAP_CONTEXT, **CLAP_KW)


def clap_weights(tmodel: str) -> dict[str, np.ndarray]:
    """The CLAP fixture's seeded reference-layout weights of ``tmodel``."""
    from audio_residual_tpu_torch.models import clap

    return _seeded_weights(clap.build_clap(port_clap_config(tmodel), device="cpu"), CLAP_SEED)


def jax_clap_config(tmodel: str):
    """The JAX package's CLAPConfig of the CLAP fixture's ``tmodel``."""
    from audio_residual_tpu.models import bart, clap, clip_text, roberta
    from audio_residual_tpu.models.htsat import HTSATConfig

    text_cls = {"roberta": roberta.RobertaConfig, "bert": roberta.RobertaConfig,
                "bart": bart.BartConfig, "transformer": clip_text.ClipTextConfig}[tmodel]
    return clap.CLAPConfig(audio=HTSATConfig(**AUDIO_KW), text=text_cls(**CLAP_TEXT_KW[tmodel]),
                           text_model_type=tmodel, context_length=CLAP_CONTEXT, **CLAP_KW)


def build_clap() -> dict[str, np.ndarray]:
    """The CLAP fixture's arrays: ``config``, ``wav``, ``text/<tmodel>/*``
    and ``out/<tmodel>/<key>``."""
    import jax.numpy as jnp

    from audio_residual_tpu.data.featurize import featurize_batch
    from audio_residual_tpu.models import clap, convert
    from audio_residual_tpu.ops.quantize import quantize_roundtrip

    rng = np.random.default_rng(CLAP_SEED)
    wav = (rng.standard_normal((2, AUDIO_KW["clip_samples"] // 2)) * 0.1).astype(np.float32)
    arrays = {"config": np.asarray(json.dumps({"audio": AUDIO_KW, **CLAP_KW, "seed": CLAP_SEED,
                                               "text": CLAP_TEXT_KW})),
              "wav": wav}
    for tmodel in CLAP_TEXT_KW:
        cfg = jax_clap_config(tmodel)
        params = convert.convert_clap_state_dict(clap_weights(tmodel), AUDIO_KW["depths"])
        text = text_inputs(tmodel)
        ids, mask = jnp.asarray(text["input_ids"]), jnp.asarray(text["attention_mask"])
        batch = featurize_batch(quantize_roundtrip(jnp.asarray(wav)), cfg.audio.clip_samples)
        out = clap.clap_apply(params, batch, ids, mask, cfg)
        arrays.update({f"text/{tmodel}/{k}": v for k, v in text.items()})
        arrays.update({f"out/{tmodel}/{k}": np.asarray(out[k]) for k in CLAP_APPLY_KEYS})
        if tmodel == "roberta":
            arrays["out/roberta/text_features_bf16"] = np.asarray(clap.encode_text(
                params, ids, mask, cfg, compute_dtype=jnp.bfloat16))
    return arrays


def run_port_clap(arrays: dict, tmodel: str, device, compute_dtype=None) -> dict[str, np.ndarray]:
    """The port's ``clap_apply`` outputs on the CLAP fixture's input for
    ``tmodel`` (weights from the seed), quantize -> featurize first; with
    ``compute_dtype`` the AMP mode. Imports torch and the port only."""
    import torch

    from audio_residual_tpu_torch.data.featurize import featurize_batch
    from audio_residual_tpu_torch.models import clap
    from audio_residual_tpu_torch.ops.quantize import quantize_roundtrip

    model = clap.build_clap(port_clap_config(tmodel), device=device)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in clap_weights(tmodel).items()})
    dev = model.logit_scale_a.device
    wav = torch.tensor(arrays["wav"], device=dev)
    batch = featurize_batch(quantize_roundtrip(wav), model.cfg.audio.clip_samples)
    with torch.no_grad():
        out = clap.clap_apply(model, batch, arrays[f"text/{tmodel}/input_ids"],
                              arrays[f"text/{tmodel}/attention_mask"],
                              compute_dtype=compute_dtype)
    return {k: out[k].float().cpu().numpy() for k in CLAP_APPLY_KEYS}


PANN_PATH = PATH.with_name("torch_port_pann.npz")
PANN_SEED = 0
PANN_CLIP = 24000  # 0.5 s at 48 kHz
PANN_MODELS = {"cnn14": dict(model_name="Cnn14"),
               "cnn6_aff_2d": dict(model_name="Cnn6", enable_fusion=True, fusion_type="aff_2d")}
PANN_JOINT = 32
PANN_OUTPUT_KEYS = ("embedding", "clipwise_output", "normalized")

FUSION_PATH = PATH.with_name("torch_port_fusion.npz")
FUSION_SEED = 0
FUSION_TYPES = ("daf_1d", "aff_1d", "iaff_1d", "daf_2d", "aff_2d", "iaff_2d", "channel_map")
FUSION_OUTPUT_KEYS = ("embedding", "clipwise_output", "normalized")


def _jax_bn(sd: dict, key: str) -> dict:
    return {"scale": sd[key + ".weight"], "bias": sd[key + ".bias"],
            "mean": sd[key + ".running_mean"], "var": sd[key + ".running_var"]}


def _jax_conv(w: np.ndarray) -> np.ndarray:
    """OIHW -> HWIO, OIW -> WIO."""
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0) if w.ndim == 4 else (2, 1, 0)))


def jax_fusion_params(sd: dict, prefix: str) -> dict:
    """The fusion keys under ``prefix`` of a reference-layout state dict ->
    the JAX package's pytree: ``fusion_model`` (AFF / iAFF branches),
    ``mel_conv1d`` (``{"conv", "bn"}``), PANN's ``mel_conv2d`` (``{"conv",
    "bn"}``) and HTSAT's ``patch_embed.mel_conv2d`` / ``.fusion_model``,
    where they are there."""
    out: dict = {}
    fm = prefix + "fusion_model."
    branches = sorted({k[len(fm):].split(".")[0] for k in sd if k.startswith(fm)})
    if branches:
        out["fusion_model"] = {}
        for name in branches:
            first = 1 if name.startswith("global") else 0
            b = {}
            for k, (conv, bn) in enumerate((("conv1", "bn1"), ("conv2", "bn2"))):
                i = first + 3 * k
                b[conv] = {"kernel": _jax_conv(sd[f"{fm}{name}.{i}.weight"]),
                           "bias": sd[f"{fm}{name}.{i}.bias"]}
                b[bn] = _jax_bn(sd, f"{fm}{name}.{i + 1}")
            out["fusion_model"][name] = b
    for conv in ("mel_conv1d", "mel_conv2d"):
        if prefix + conv + ".0.weight" in sd:
            out[conv] = {"conv": {"kernel": _jax_conv(sd[f"{prefix}{conv}.0.weight"]),
                                  "bias": sd[f"{prefix}{conv}.0.bias"]},
                         "bn": _jax_bn(sd, f"{prefix}{conv}.1")}
    if prefix + "patch_embed.mel_conv2d.weight" in sd:
        out["patch_embed"] = {
            "mel_conv2d": {"kernel": _jax_conv(sd[prefix + "patch_embed.mel_conv2d.weight"]),
                           "bias": sd[prefix + "patch_embed.mel_conv2d.bias"]},
            **jax_fusion_params(sd, prefix + "patch_embed.")}
    return out


def jax_audio_params(sd: dict, audio_model_type: str, depths=None) -> dict:
    """``{"audio_branch", "audio_projection"}`` in the JAX package's layout
    from a reference-layout audio state dict (HTSAT or PANN, any fusion)."""
    from audio_residual_tpu.models import convert

    pre = "audio_branch."
    if audio_model_type == "PANN":
        branch = convert.convert_pann_state_dict(sd, pre)
    else:
        branch = convert.convert_htsat_state_dict(sd, pre, depths)
    extra = jax_fusion_params(sd, pre)
    if "patch_embed" in extra:
        branch["patch_embed"].update(extra.pop("patch_embed"))
    branch.update(extra)
    proj = {f"fc{i}": {"kernel": sd[f"audio_projection.{j}.weight"].T,
                       "bias": sd[f"audio_projection.{j}.bias"]} for i, j in ((1, 0), (2, 2))}
    return {"audio_branch": branch, "audio_projection": proj}


def pann_port_config(name: str, clip_samples: int = PANN_CLIP, **kw):
    """The port's CLAPConfig of a PANN tower (``PANN_MODELS[name]`` or
    ``model_name`` / fusion keywords)."""
    from audio_residual_tpu_torch.models import clap, pann

    audio = pann.PANNConfig(clip_samples=clip_samples, **{**PANN_MODELS.get(name, {}), **kw})
    return clap.CLAPConfig(embed_dim=audio.embed_dim, joint_embed_shape=PANN_JOINT, audio=audio,
                           audio_model_type="PANN")


def pann_jax_config(name: str, clip_samples: int = PANN_CLIP, **kw):
    from audio_residual_tpu.models import clap
    from audio_residual_tpu.models.pann import PANNConfig

    from .tiny import TINY_TEXT

    audio = PANNConfig(clip_samples=clip_samples, **{**PANN_MODELS.get(name, {}), **kw})
    return clap.CLAPConfig(embed_dim=audio.embed_dim, joint_embed_shape=PANN_JOINT, audio=audio,
                           text=TINY_TEXT, audio_model_type="PANN")


def port_weights(cfg, seed: int) -> dict[str, np.ndarray]:
    """Seeded reference-layout weights of the port's audio model of ``cfg``."""
    import torch

    from audio_residual_tpu_torch.models import clap

    with torch.device("meta"):
        model = clap.CLAPAudio(cfg)
    return seeded_state_dict({k: tuple(v.shape) for k, v in model.state_dict().items()}, seed)


def fusion_port_config(fusion_type: str):
    from audio_residual_tpu_torch.models import clap, htsat

    return clap.CLAPConfig(audio=htsat.HTSATConfig(**AUDIO_KW, enable_fusion=True,
                                                    fusion_type=fusion_type), **CLAP_KW)


def fusion_jax_config(fusion_type: str):
    from audio_residual_tpu.models import clap
    from audio_residual_tpu.models.htsat import HTSATConfig

    from .tiny import TINY_TEXT

    return clap.CLAPConfig(audio=HTSATConfig(**AUDIO_KW, enable_fusion=True,
                                             fusion_type=fusion_type), text=TINY_TEXT, **CLAP_KW)


def fusion_inputs(seed: int, mel_bins: int, frames: int) -> dict[str, np.ndarray]:
    """A seeded fusion batch: ``mel_fusion [2, 4, frames, mel_bins]`` (a
    log-mel's scale: around -20 dB) and ``longer`` = [True, False]."""
    rng = np.random.default_rng(seed)
    mel = (rng.standard_normal((2, 4, frames, mel_bins)) * 10 - 20).astype(np.float32)
    return {"mel_fusion": mel, "longer": np.array([True, False])}


def build_pann() -> dict[str, np.ndarray]:
    """The PANN fixture's arrays: ``config``, ``wav``, ``mel_fusion``,
    ``longer`` and ``out/<model>/<key>``."""
    import jax.numpy as jnp

    from audio_residual_tpu.models import clap

    rng = np.random.default_rng(PANN_SEED)
    wav = (rng.standard_normal((2, PANN_CLIP)) * 0.1).astype(np.float32)
    fusion = fusion_inputs(PANN_SEED, 64, PANN_CLIP // 480 + 1)
    arrays = {"config": np.asarray(json.dumps({"models": PANN_MODELS, "clip": PANN_CLIP,
                                               "joint": PANN_JOINT, "seed": PANN_SEED})),
              "wav": wav, **fusion}
    for name in PANN_MODELS:
        params = jax_audio_params(port_weights(pann_port_config(name), PANN_SEED), "PANN")
        batch = ({"mel_fusion": jnp.asarray(fusion["mel_fusion"]),
                  "longer": jnp.asarray(fusion["longer"])}
                 if PANN_MODELS[name].get("enable_fusion") else {"waveform": jnp.asarray(wav)})
        out = clap.encode_audio(params, batch, pann_jax_config(name))
        arrays.update({f"out/{name}/{k}": np.asarray(out[k]) for k in PANN_OUTPUT_KEYS})
    return arrays


def build_fusion() -> dict[str, np.ndarray]:
    """The fusion fixture's arrays: ``config``, ``mel_fusion``, ``longer``
    and ``out/<fusion type>/<key>``."""
    import jax.numpy as jnp

    from audio_residual_tpu.models import clap

    fusion = fusion_inputs(FUSION_SEED, AUDIO_KW["mel_bins"],
                           AUDIO_KW["clip_samples"] // 480 + 1)
    arrays = {"config": np.asarray(json.dumps({"audio": AUDIO_KW, **CLAP_KW,
                                               "seed": FUSION_SEED})), **fusion}
    batch = {k: jnp.asarray(v) for k, v in fusion.items()}
    for ft in FUSION_TYPES:
        params = jax_audio_params(port_weights(fusion_port_config(ft), FUSION_SEED), "HTSAT",
                                  AUDIO_KW["depths"])
        out = clap.encode_audio(params, batch, fusion_jax_config(ft))
        arrays.update({f"out/{ft}/{k}": np.asarray(out[k]) for k in FUSION_OUTPUT_KEYS})
    return arrays


def _seeded_model(cfg, seed: int, device):
    import torch

    from audio_residual_tpu_torch.models import clap

    model = clap.build_clap_audio(cfg, device=device)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in port_weights(cfg, seed).items()})
    return model


def run_port_pann(arrays: dict, device) -> dict[str, dict[str, np.ndarray]]:
    """The port's ``encode_audio`` outputs of each PANN fixture model.
    Imports torch and the port only."""
    import torch

    from audio_residual_tpu_torch.models import clap

    out = {}
    for name, kw in PANN_MODELS.items():
        model = _seeded_model(pann_port_config(name), PANN_SEED, device)
        dev = model.audio_projection[0].weight.device
        batch = ({"mel_fusion": torch.tensor(arrays["mel_fusion"], device=dev),
                  "longer": torch.tensor(arrays["longer"], device=dev)}
                 if kw.get("enable_fusion") else {"waveform": torch.tensor(arrays["wav"],
                                                                           device=dev)})
        with torch.no_grad():
            o = clap.encode_audio(model, batch)
        out[name] = {k: o[k].float().cpu().numpy() for k in PANN_OUTPUT_KEYS}
    return out


def run_port_fusion(arrays: dict, device, compute_dtype=None) -> dict[str, dict[str, np.ndarray]]:
    """The port's ``encode_audio`` outputs of each fusion type on the fusion
    fixture's batch. Imports torch and the port only."""
    import torch

    from audio_residual_tpu_torch.models import clap

    out = {}
    for ft in FUSION_TYPES:
        model = _seeded_model(fusion_port_config(ft), FUSION_SEED, device)
        dev = model.audio_projection[0].weight.device
        batch = {k: torch.tensor(arrays[k], device=dev) for k in ("mel_fusion", "longer")}
        with torch.no_grad():
            o = clap.encode_audio(model, batch, compute_dtype=compute_dtype)
        out[ft] = {k: o[k].float().cpu().numpy() for k in FUSION_OUTPUT_KEYS}
    return out


VISION_PATH = PATH.with_name("torch_port_vision.npz")
VISION_SEED = 0
VISION_TEXT = dict(vocab_size=1000, width=64, heads=2, layers=2, context_length=CLAP_CONTEXT)
VISION_MODELS = {  # narrow CLIPs: the ModifiedResNet (4 heads in its pool) and a quick-GELU ViT
    "rn": dict(layers=[1, 1, 1, 1], width=8, image_size=64),
    "vit": dict(layers=2, width=64, patch_size=8, image_size=32, quick_gelu=True),
}
VISION_EMBED = 32
VISION_OUTPUT_KEYS = ("image", "text", "logit_scale")


def seeded_tree_leaves(shapes: dict[str, tuple], seed: int) -> dict[str, np.ndarray]:
    """Random leaves of a JAX param pytree, keyed by its ``/`` paths in the
    order given: BN scales near 1, variances above 0.5, other vectors at
    0.1, arrays of two or more axes at ``1/sqrt(fan_in)`` (all axes but the
    last), ``logit_scale`` ``log(1/0.07)``."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in shapes.items():
        z = rng.standard_normal(shape)
        name = key.rsplit("/", 1)[-1]
        if name == "var":
            v = 0.5 + 0.5 * np.abs(z)
        elif name == "scale":
            v = 1 + 0.1 * z
        elif name == "logit_scale":
            v = np.full(shape, np.log(1 / 0.07))
        elif len(shape) >= 2:
            v = z / np.sqrt(np.prod(shape[:-1]))
        else:
            v = 0.1 * z
        out[key] = np.asarray(v, dtype=np.float32)
    return out


def eval_shapes(init_fn) -> dict[str, tuple]:
    """``{path: shape}`` of the JAX pytree ``init_fn(key)`` returns, sorted
    by path, from ``jax.eval_shape``: no weights are made."""
    import jax

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: v for key in tree for k, v in walk(tree[key], f"{prefix}/{key}").items()}
        if isinstance(tree, (list, tuple)):
            return {k: v for i, x in enumerate(tree) for k, v in walk(x, f"{prefix}/{i}").items()}
        return {prefix.lstrip("/"): tuple(tree.shape)}

    return dict(sorted(walk(jax.eval_shape(init_fn, jax.random.PRNGKey(0)), "").items()))


def vision_configs(package) -> dict:
    """``{name: CLIPConfig}`` of the vision fixture in ``package``'s
    classes (``audio_residual_tpu`` or ``audio_residual_tpu_torch``)."""
    import importlib

    clip = importlib.import_module(f"{package}.models.clip")
    vision = importlib.import_module(f"{package}.models.vision")
    clip_text = importlib.import_module(f"{package}.models.clip_text")
    out = {}
    for name, kw in VISION_MODELS.items():
        kw = {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}
        text = clip_text.ClipTextConfig(**VISION_TEXT, quick_gelu=kw.get("quick_gelu", False))
        out[name] = clip.CLIPConfig(embed_dim=VISION_EMBED, vision=vision.VisionCfg(**kw),
                                    text=text)
    return out


def vision_inputs(seed: int = VISION_SEED) -> dict[str, np.ndarray]:
    """NHWC images of each model's size (2 each) and 3 CLIP token rows."""
    rng = np.random.default_rng(seed + 1)
    out = {f"images/{name}": rng.standard_normal(
        (2, kw["image_size"], kw["image_size"], 3)).astype(np.float32)
        for name, kw in VISION_MODELS.items()}
    return {**out, "tokens": text_inputs("transformer", batch=3, seed=seed + 2)["input_ids"]}


def vision_params(arrays: dict, name: str) -> dict:
    """The JAX CLIP pytree (numpy leaves) of fixture model ``name``: its
    stored leaf shapes, values from the seed."""
    shapes = json.loads(str(arrays[f"shapes/{name}"]))
    return _unflatten(seeded_tree_leaves({k: tuple(v) for k, v in shapes.items()},
                                         VISION_SEED))


def build_vision() -> dict[str, np.ndarray]:
    """The vision fixture's arrays: ``config``, ``shapes/<model>`` (the JAX
    pytree's leaf paths and shapes, JSON), the inputs and
    ``out/<model>/{image,text,logit_scale}``: ``clip_apply``'s outputs."""
    import jax
    import jax.numpy as jnp

    from audio_residual_tpu.models import clip

    arrays = {"config": np.asarray(json.dumps({"models": VISION_MODELS, "text": VISION_TEXT,
                                               "embed": VISION_EMBED, "seed": VISION_SEED})),
              **vision_inputs()}
    for name, cfg in vision_configs("audio_residual_tpu").items():
        shapes = eval_shapes(functools.partial(clip.init_clip_params, cfg=cfg))
        arrays[f"shapes/{name}"] = np.asarray(json.dumps(shapes))
        params = jax.tree.map(jnp.asarray, vision_params(arrays, name))
        out = jax.jit(functools.partial(clip.clip_apply, cfg=cfg))(
            params, jnp.asarray(arrays[f"images/{name}"]), jnp.asarray(arrays["tokens"]))
        arrays.update({f"out/{name}/{k}": np.asarray(v)
                       for k, v in zip(VISION_OUTPUT_KEYS, out)})
    return arrays


def run_port_vision(arrays: dict, device) -> dict[str, dict[str, np.ndarray]]:
    """The port's ``clip_apply`` outputs of each vision fixture model (NCHW
    images). Imports torch and the port only."""
    import torch

    from audio_residual_tpu_torch.models import clip
    from audio_residual_tpu_torch.models.convert import load_jax_params

    out = {}
    for name, cfg in vision_configs("audio_residual_tpu_torch").items():
        model = load_jax_params(clip.build_clip(cfg, device=device),
                                vision_params(arrays, name))
        images = torch.from_numpy(arrays[f"images/{name}"].transpose(0, 3, 1, 2).copy())
        with torch.no_grad():
            o = clip.clip_apply(model, images.to(model.logit_scale.device), arrays["tokens"])
        out[name] = {k: v.float().cpu().numpy() for k, v in zip(VISION_OUTPUT_KEYS, o)}
    return out


FIXTURES = {"tiny": (PATH, build), "wide": (WIDE_PATH, build_wide),
            "train": (TRAIN_PATH, build_train), "clap": (CLAP_PATH, build_clap),
            "pann": (PANN_PATH, build_pann), "fusion": (FUSION_PATH, build_fusion),
            "vision": (VISION_PATH, build_vision)}


def main(names=()) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")  # the tests' f32 CPU reference
    PATH.parent.mkdir(parents=True, exist_ok=True)
    for name in names or FIXTURES:
        path, make = FIXTURES[name]
        np.savez_compressed(path, **make())
        print(f"wrote {path} ({path.stat().st_size} bytes)")


if __name__ == "__main__":
    import sys

    main(sys.argv[1:])
