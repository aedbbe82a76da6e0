"""The enc-dec (whisper) and RWKV6 families across ranks: the port's
``serve_step`` and ``train_loss`` on a ``(data, model)`` mesh over
``torch.distributed`` (``gloo``, one process per rank) against the JAX
reference's ``shard_map``'d ones over the same mesh of forced CPU devices,
on reduced whisper-tiny (``num_kv_heads=2``, so that tp 4 has two K/V
replicas a head) and reduced rwkv6-3b, with the reference's
``model.init(0)`` drawn at each mesh's tp and bridged by
``params_from_numpy`` (serving weights, or fp32 masters for training).

Cases: whisper serving 1 x 2 (packed with frames, padded prefill with
frames, decode), 1 x 4 with K/V replicas (packed, decode), 2 x 1 padded
rows over "data" (prefill, decode) and 2 x 1 ``sp`` (decode); RWKV6
serving 1 x 2 (packed, prefill, decode) and 2 x 1 padded rows (prefill,
decode); training (loss and every leaf's gradient) of both at 1 x 2 and
2 x 2. Each rank's serving batch is ``input_specs.split_batch`` of one
(1, 1) batch, its buffer random old pages and states. Bars:

* logits within 1e-2 (``LOGIT_TOL``, the mesh serving file's);
* written self and cross K/V within 2 bf16 ulps of the written pages'
  largest value (``KV_ULPS``); RWKV6 state as the hybrid's: the wkv part
  within 2e-2 of its largest magnitude, the token shifts (bf16 values)
  within 2 ulps; every other byte of every rank's buffer (the scratch
  page excepted) unchanged;
* the loss within 2e-4 and each leaf's gradient within 3e-2 relative L2
  (the one-device bars of these families, ``test_torch_train_rwkv_encdec``),
  both meshes against the reference's 2 x 2 (its 1 x 2 of the same
  weights is the same function).

Besides: each 1 x 1 mesh equal bit for bit to the one-device path
(serving and training); a checkpoint written by the 2 x 2 ``Trainer``
restored at 1 x 2 and continued; and the reference behaviours these
families show on a mesh (ROADMAP queue 3): RWKV6's ``ln_x`` normalises
over a rank's heads and its channel mix's ``cm_wv`` maps a rank's
``d_ff`` columns to its output columns only; its ``w_lora_a`` copies
receive only their own heads' gradient and drift apart; enc-dec under
``sp`` combines its self attention over the K/V replica set only, so each
data rank attends only the pages it holds.

The JAX side runs in one background process (this file run as a script
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, ``jax.jit``
of every step); the port's meshes run one ``gloo`` world per mesh shape,
every case of that shape in it. Every run has a deadline and every
collective times out.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # see scripts/torch_cpu_first_vml_call.py

from repro_torch.configs import ARCHS, reduced  # noqa: E402
from repro_torch.launch.dryrun import mesh_train_bytes  # noqa: E402
from repro_torch.launch.input_specs import (example_batch,  # noqa: E402
                                            example_pool, split_batch)
from repro_torch.launch.mesh import run_mesh  # noqa: E402
from repro_torch.models import blocks_seq, build_model  # noqa: E402
from repro_torch.models import params_from_numpy  # noqa: E402
from repro_torch.models.common import rms_norm  # noqa: E402
from repro_torch.models.params import gather_tree  # noqa: E402
from repro_torch.models.tp import Dist, replica_info  # noqa: E402
from repro_torch.training import (AdamWConfig, SyntheticLM, Trainer,  # noqa: E402
                                  TrainerConfig, init)
from repro_torch.training.optimizer import leaves  # noqa: E402
from test_torch_mesh_serve import (KV_ULPS, LOGIT_TOL, _bf16,  # noqa: E402
                                   _dump, _load, _wait_for, bf16_ulp,
                                   to_batch)
from test_torch_mesh_train import _flat, _rel  # noqa: E402

DEADLINE = 150.0
LOSS_TOL, GRAD_TOL, STATE_TOL = 2e-4, 3e-2, 2e-2
WHISPER, RWKV = "whisper-tiny", "rwkv6-3b"
OVERRIDES = {WHISPER: {"num_kv_heads": 2}, RWKV: {}}
# name -> (arch, (dp, tp), sp, layouts)
SERVE = {
    "w-1x2": (WHISPER, (1, 2), False, ("packed", "prefill", "decode")),
    "w-1x4": (WHISPER, (1, 4), False, ("packed", "decode")),
    "w-2x1": (WHISPER, (2, 1), False, ("prefill", "decode")),
    "w-2x1-sp": (WHISPER, (2, 1), True, ("decode",)),
    "r-1x2": (RWKV, (1, 2), False, ("packed", "prefill", "decode")),
    "r-2x1": (RWKV, (2, 1), False, ("prefill", "decode")),
}
# name -> (arch, (dp, tp)); the reference runs the 2 x 2 cases only: its
# 1 x 2 mesh of the same weights computes the same function (the batch's
# rows over one data rank instead of two)
TRAIN = {"w-t1x2": (WHISPER, (1, 2)), "w-t2x2": (WHISPER, (2, 2)),
         "r-t1x2": (RWKV, (1, 2)), "r-t2x2": (RWKV, (2, 2))}
TRAIN_REF = {"w-t1x2": "w-t2x2", "w-t2x2": "w-t2x2", "r-t1x2": "r-t2x2",
             "r-t2x2": "r-t2x2"}
SEQS = {"packed": [(0, 7), (9, 5), (13, 1), (6, 1)],
        "prefill": [(0, 6), (9, 4), (5, 3), (13, 2)],
        "decode": [(13, 1), (6, 1), (21, 1), (2, 1)]}
PAGES = 48
ADAMW = dict(lr=1e-2, warmup_steps=5, total_steps=200)
DATA = dict(seq_len=32, global_batch=8, mode="markov")
RESUME = 1          # the step the 2 x 2 Trainer checkpoints
RESUME_TOL = 5e-3


def _cfg(arch):
    return reduced(ARCHS[arch], **OVERRIDES[arch])


def _rank_model(arch, mesh, sp=False):
    cfg = _cfg(arch)
    repl = replica_info(cfg.num_heads, cfg.num_kv_heads, mesh[1])["repl"] \
        if cfg.family == "encdec" else 1
    return build_model(cfg, Dist(dp=mesh[0], tp=mesh[1], sp=sp, repl=repl))


def _batch(cfg):
    """A training batch: (tokens, targets) and, for enc-dec, frames."""
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    tgt = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    extra = {}
    if cfg.family == "encdec":
        extra["enc_embeds"] = rng.standard_normal(
            (4, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return tok, tgt, extra


def _frames(cfg):
    """``Trainer.extra_batch`` for enc-dec: each row's frames, from the
    step's first token."""
    if cfg.family != "encdec":
        return None

    def extra(tokens):
        rng = np.random.default_rng([5, int(tokens[0, 0])])
        return {"enc_embeds": rng.standard_normal(
            (tokens.shape[0], cfg.encoder_seq, cfg.d_model),
            dtype=np.float32)}
    return extra


# ------------------------------------------------------------ the inputs
def make_buffer(model, units, seed):
    """A rank's buffer (uint16 bf16 bits): N(0, 1) bf16 in the attention
    and cross pages, N(0, 0.1) fp32 state (bf16 pairs, no low half a NaN
    pattern, which the reference's CPU scatter would canonicalise) in the
    state pages, zeros in the scratch page."""
    rng = np.random.default_rng(seed)
    _, first, _ = example_pool(model, PAGES)
    buf = np.zeros(units, np.uint16)
    for s in model.kv_specs():
        lo = first[s.name][0] * s.page_units
        n = first[s.name][1] * s.page_units
        if s.kind == "rwkv":
            bits = (rng.standard_normal(n // 2) * 0.1).astype(
                np.float32).view(np.uint32)
            bits[(bits & 0x7F80) == 0x7F80] ^= 0x4000
            buf[lo:lo + n] = bits.view(np.uint16)
        else:
            x = rng.standard_normal(n).astype(np.float32)
            buf[lo:lo + n] = (x.view(np.uint32) >> 16).astype(np.uint16)
    return buf


def case_inputs(name):
    arch, mesh, sp, layouts = SERVE[name]
    model = _rank_model(arch, mesh, sp)
    out = {}
    for li, layout in enumerate(layouts):
        seed = 1000 * (list(SERVE).index(name) + 1) + li
        arrs, units = example_batch(model, SEQS[layout], layout == "packed",
                                    seed, PAGES)
        ranks = {(d, m): (split_batch(arrs, model, d, m),
                          make_buffer(model, units, seed * 16 + d * mesh[1]
                                      + m))
                 for d in range(mesh[0]) for m in range(mesh[1])}
        out[layout] = dict(arrs=arrs, ranks=ranks)
    return out


# ------------------------------------------------------------- JAX side
def _global(arrs_by_rank, mesh, sp, packed):
    """The reference's global batch from the ranks' batches (the mesh
    serving file's ``_global``, with the enc-dec fields): per-type tables,
    page starts, owners, write ids and the cross write ids (s_dim, tp,
    B_loc, .), state ids (s_dim, B_loc), and the per-row fields over the
    data axis (padded, not sp) or the batch's own."""
    dp, tp = mesh
    any_rank = arrs_by_rank[(0, 0)]
    g = {}
    for f, v in any_rank.items():
        if f in ("tables", "page_pos", "write_eids", "page_seg"):
            g[f] = None if v is None else {k: np.stack([np.stack(
                [arrs_by_rank[(d, m)][f][k][0, 0] for m in range(tp)])
                for d in range(dp)]) for k in v}
        elif f == "enc_write_eids" and v is not None:
            g[f] = np.stack([np.stack([arrs_by_rank[(d, m)][f][0, 0]
                                       for m in range(tp)])
                             for d in range(dp)])
        elif f == "state_eids":
            g[f] = {k: np.stack([arrs_by_rank[(d, 0)][f][k][0]
                                 for d in range(dp)]) for k in v}
        elif v is None or packed or sp or dp == 1:
            g[f] = v
        else:
            g[f] = np.concatenate([arrs_by_rank[(d, 0)][f]
                                   for d in range(dp)], axis=0)
    return g


def _jax_reference(tmp: str):
    """The reference's results under ``tmp``: the params of every (arch,
    tp) (``jax-params.pkl``, written first), then every serving case's
    global logits and ranks' buffers and the 2 x 2 training cases' loss and
    gradients (``jax-main.pkl``)."""
    import time

    import jax
    import jax.numpy as jnp

    from repro.configs import ARCHS as JARCHS
    from repro.configs import reduced as jreduced
    from repro.models.lm import DecodeBatch as JBatch
    from repro.models.registry import build_model as jbuild
    from repro.models.tp import Dist as JDist
    from repro.models.tp import make_mesh_auto

    t0 = time.monotonic()
    inputs = _load(os.path.join(tmp, "inputs.pkl"))

    def model(arch, mesh, sp=False):
        jmesh = make_mesh_auto(mesh, ("data", "model"),
                               devices=jax.devices()[:mesh[0] * mesh[1]])
        return jbuild(jreduced(JARCHS[arch], **OVERRIDES[arch]),
                      JDist(mesh=jmesh, sp=sp))

    drawn = {}
    for arch, mesh in [v[:2] for v in SERVE.values()] + list(TRAIN.values()):
        if (arch, mesh[1]) not in drawn:
            m = model(arch, (1, mesh[1]))
            drawn[(arch, mesh[1])] = jax.tree.map(
                np.asarray, jax.jit(m.init, static_argnums=0)(0))
    _dump(drawn, os.path.join(tmp, "jax-params.pkl"))
    res = {}
    for name, (arch, mesh, sp, layouts) in SERVE.items():
        m = model(arch, mesh, sp)
        params = drawn[(arch, mesh[1])]
        for layout in layouts:
            ranks = inputs[name][layout]["ranks"]
            g = _global({k: b for k, (b, _) in ranks.items()}, mesh, sp,
                        layout == "packed")
            batch = JBatch(**{f: (None if v is None else jax.tree.map(
                jnp.asarray, v)) for f, v in g.items()})
            buf = np.stack([np.stack([ranks[(d, k)][1]
                                      for k in range(mesh[1])])
                            for d in range(mesh[0])])
            step = jax.jit(lambda p, b, x, m=m, pf=layout != "decode":
                           m.serve_step(p, b, x, prefill=pf))
            logits, out = step(params, jnp.asarray(buf.view(jnp.bfloat16)),
                               batch)
            res[(name, layout)] = (np.asarray(logits),
                                   np.asarray(out).view(np.uint16))
            print(f"{name} {layout} {time.monotonic() - t0:.1f} s",
                  flush=True)
    for name in sorted(set(TRAIN_REF.values())):
        arch, mesh = TRAIN[name]
        m = model(arch, mesh)
        tok, tgt, extra = _batch(m.cfg)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, a, b, e: m.train_loss(p, a, b, **e)))(
                drawn[(arch, mesh[1])], tok, tgt, extra)
        res[name] = dict(loss=float(loss),
                         grads=jax.tree.map(np.asarray, grads))
        print(f"{name} {time.monotonic() - t0:.1f} s", flush=True)
    _dump(res, os.path.join(tmp, "jax-main.pkl"))


def _start_jax(tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    log = open(os.path.join(tmp, "jax.log"), "w")
    return subprocess.Popen([sys.executable, __file__, tmp], env=env,
                            stdout=log, stderr=subprocess.STDOUT)


# ----------------------------------------------------------- torch side
def _trainer(model, ckpt, micro=1, every=1 << 30):
    return Trainer(model, AdamWConfig(**ADAMW), TrainerConfig(
        ckpt_dir=ckpt, ckpt_every=every, micro_batches=micro, zero1=True),
        extra_batch=_frames(model.cfg))


def _serve(dist, dev, tmp, name, jparams, inputs):
    arch, mesh, sp, layouts = SERVE[name]
    cfg = _cfg(arch)
    d = dataclasses.replace(dist, sp=sp)
    model = build_model(cfg, d)
    params = params_from_numpy(jparams[(arch, mesh[1])], cfg, dev, dist=d)
    out = {}
    for layout in layouts:
        batch, buf = inputs[name][layout]["ranks"][(d.data_rank,
                                                     d.model_rank)]
        buf = torch.from_numpy(buf.copy()).view(torch.bfloat16)
        before = dict(d.comm_bytes)
        logits = model.serve_step(params, buf, to_batch(batch),
                                  prefill=layout != "decode")
        out[(name, layout)] = (logits.numpy(), buf.view(torch.int16).numpy()
                               .view(np.uint16),
                               {k: d.comm_bytes[k] - before[k]
                                for k in before})
    return out


def _train(dist, dev, tmp, name, jparams):
    """One training case on this rank: the loss and the gathered
    gradients of ``_batch``; the rank's bytes against the planner's; at
    2 x 2, a Trainer's losses with a checkpoint at step RESUME; at 1 x 2
    RWKV6, ``w_lora_a`` before and after one Trainer step."""
    arch, mesh = TRAIN[name]
    cfg = _cfg(arch)
    model = build_model(cfg, dist)
    params = params_from_numpy(jparams[(arch, mesh[1])], cfg, dev,
                               master=True, dist=dist)
    tok, tgt, extra = _batch(cfg)
    tr = _trainer(model, os.path.join(tmp, "unused"))
    loss, grads = tr.loss_and_grads(
        params, torch.from_numpy(tok), torch.from_numpy(tgt),
        {k: torch.from_numpy(v) for k, v in extra.items()})
    grads = gather_tree(grads, model.shards(), dist)
    tr._release(params)
    run = _trainer(model, os.path.join(tmp, f"port-{name}"), micro=2,
                   every=RESUME if mesh == (2, 2) else 1 << 30)
    state = init(params, run.layout)
    nbytes = dict(params=4 * sum(t.numel() for t in leaves(params)),
                  moments=4 * sum(t.numel() for t in leaves(state.mu)) * 2)
    out = dict(nbytes=nbytes)
    if mesh == (2, 2) or cfg.family == "ssm":
        steps = RESUME + 2 if mesh == (2, 2) else 1
        w0 = gather_tree({"w": params["layers"]["w_lora_a"]},
                         {"w": model.shards()["layers"]["w_lora_a"]},
                         dist)["w"] if cfg.family == "ssm" else None
        params, _, out["hist"] = run.run(params, state, SyntheticLM(
            cfg.vocab_size, **DATA), num_steps=steps)
        if cfg.family == "ssm":
            out["lora"] = (w0, gather_tree(
                {"w": params["layers"]["w_lora_a"]},
                {"w": model.shards()["layers"]["w_lora_a"]}, dist)["w"])
    if dist.rank == 0:
        out.update(loss=float(loss), grads=grads)
    return out


def _resume(dist, dev, tmp, name):
    """A 2 x 2 Trainer's checkpoint restored on this mesh and continued
    for two steps."""
    arch, _ = TRAIN[name]
    cfg = _cfg(arch)
    tr = _trainer(build_model(cfg, dist), os.path.join(tmp, f"port-{name}"),
                  micro=2)
    p, s, _ = tr.restore(RESUME, device=dev)
    _, _, hist = tr.run(p, s, SyntheticLM(cfg.vocab_size, **DATA),
                        num_steps=RESUME + 2, start_step=RESUME)
    return hist


def _own_loss(arch, dist, dev):
    """The loss of ``_batch`` on the port's own init at ``dist``."""
    cfg = _cfg(arch)
    model = build_model(cfg, dist)
    params = model.init(0, device=dev, master=True)
    tok, tgt, extra = _batch(cfg)
    with torch.no_grad():
        return float(model.train_loss(
            params, torch.from_numpy(tok), torch.from_numpy(tgt),
            **{k: torch.from_numpy(v) for k, v in extra.items()}))


def _rank_world(dist, dev, tmp, names):
    """Every case of one mesh shape on this rank."""
    inputs = _load(os.path.join(tmp, "inputs.pkl"))
    jparams = _load(os.path.join(tmp, "jax-params.pkl"))
    out = {}
    for name in names:
        if name in SERVE:
            out.update(_serve(dist, dev, tmp, name, jparams, inputs))
        elif name in TRAIN:
            out[name] = _train(dist, dev, tmp, name, jparams)
        elif name.startswith("resume-"):
            out[name] = _resume(dist, dev, tmp, name[len("resume-"):])
    if (dist.dp, dist.tp) == (1, 2):
        out["own"] = _own_loss(RWKV, dist, dev)
    return out


def _rank_one(dist, dev, tmp):
    """At 1 x 1, for both families: the mesh path against the one-device
    path (no Dist) on the port's own init, bit for bit: a packed step and
    a decode step (logits and buffer), and the loss and gradients."""
    out = {}
    for arch in (WHISPER, RWKV):
        cfg = _cfg(arch)
        one, mesh = build_model(cfg), build_model(cfg, dist)
        params = one.init(0, device=dev)
        same = []
        for li, layout in enumerate(("packed", "decode")):
            arrs, units = example_batch(one, SEQS[layout],
                                        layout == "packed", 77 + li, PAGES)
            buf0 = make_buffer(one, units, 78 + li)
            res = []
            for m in (one, mesh):
                buf = torch.from_numpy(buf0.copy()).view(torch.bfloat16)
                res.append((m.serve_step(params, buf, to_batch(arrs),
                                         prefill=layout != "decode"), buf))
            same.append(torch.equal(res[0][0], res[1][0]) and torch.equal(
                res[0][1].view(torch.int16), res[1][1].view(torch.int16)))
        master = one.init(0, device=dev, master=True)
        tok, tgt, extra = _batch(cfg)
        found = []
        for m in (one, mesh):
            tr = _trainer(m, tempfile.mkdtemp(dir=tmp))
            loss, grads = tr.loss_and_grads(
                master, torch.from_numpy(tok), torch.from_numpy(tgt),
                {k: torch.from_numpy(v) for k, v in extra.items()})
            found.append((loss, [g.clone() for g in leaves(grads)]))
            tr._release(master)
        (l1, g1), (l2, g2) = found
        out[arch] = dict(serve=same, loss=torch.equal(l1, l2),
                         grads=all(torch.equal(a, b) for a, b in zip(g1, g2)))
    out["own"] = _own_loss(RWKV, dist, dev)
    return out


WORLDS = {}
for _n, (_a, _mesh, *_r) in list(SERVE.items()) + list(TRAIN.items()):
    WORLDS.setdefault(_mesh, []).append(_n)
# the 2 x 2 Trainers' checkpoints, restored at 1 x 2 (after the 2 x 2 run)
WORLDS = dict(sorted(WORLDS.items(), key=lambda kv: -kv[0][0]))
WORLDS[(1, 2)] += ["resume-w-t2x2", "resume-r-t2x2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_encdec_rwkv"))
    _dump({name: case_inputs(name) for name in SERVE},
          os.path.join(tmp, "inputs.pkl"))
    proc = _start_jax(tmp)
    try:
        _wait_for(os.path.join(tmp, "jax-params.pkl"), proc, 2 * DEADLINE)
        ours = {}
        for mesh, names in WORLDS.items():
            repl = {_rank_model(*SERVE[n][:3]).dist.repl if n in SERVE
                    else 1 for n in names}
            assert len(repl) == 1, (mesh, repl)
            ours[mesh] = run_mesh(_rank_world, mesh, args=(tmp, names),
                                  backend="gloo", device="cpu", timeout=60,
                                  deadline=DEADLINE, repl=repl.pop())
        ours["one"] = run_mesh(_rank_one, (1, 1), args=(tmp,),
                               backend="gloo", device="cpu", timeout=60,
                               deadline=DEADLINE)[0]
        _wait_for(os.path.join(tmp, "jax-main.pkl"), proc, 3 * DEADLINE)
        ref = _load(os.path.join(tmp, "jax-main.pkl"))
    finally:
        proc.kill()
        proc.wait()
    return _load(os.path.join(tmp, "inputs.pkl")), ref, ours


def _written(model, batch, units):
    """(K/V units, state units) each a mask over a rank's buffer: the
    self slots its live write ids cover and the cross slots its live
    cross write ids cover, in every layer, and its live state pages."""
    kv = np.zeros(units, bool)
    st = np.zeros(units, bool)
    views = model._layer_views(torch.empty(units))
    for s in model.kv_specs():
        shape = views[s.name]
        if s.kind == "rwkv":
            _, nl, u2 = shape
            for e in batch["state_eids"][s.name].reshape(-1):
                if e >= 0:
                    st[e * nl * u2:(e + 1) * nl * u2] = True
            continue
        _, nl, _, tpp, kvl, hd = shape
        if s.kind == "cross_attn":
            if batch.get("enc_write_eids") is None:
                continue
            w = batch["enc_write_eids"]
            pos = np.broadcast_to(np.arange(w.shape[-1]), w.shape)
        else:
            w = batch["write_eids"][s.name]
            pos = batch["positions"].reshape(w.shape)
        for e, p in zip(w.reshape(-1), pos.reshape(-1)):
            if e < 0:
                continue
            for layer in range(nl):
                for sel in (0, 1):
                    off = ((((e * nl + layer) * 2 + sel) * tpp) + p % tpp) \
                        * kvl * hd
                    kv[off:off + kvl * hd] = True
    return kv, st


def _check_state(model, ours, ref, batch):
    """Written RWKV6 state pages: the wkv part within STATE_TOL of its
    largest magnitude, the token shifts within KV_ULPS bf16 ulps."""
    _, nl, u2 = model._layer_views(torch.empty(ours.shape[0]))["rwkv"]
    n = model.rd["wkv_units"]
    for e in batch["state_eids"]["rwkv"].reshape(-1):
        if e < 0:
            continue
        for layer in range(nl):
            lo = (e * nl + layer) * u2
            a = ours[lo:lo + u2].view(np.float32)
            b = ref[lo:lo + u2].view(np.float32)
            assert np.abs(a[:n] - b[:n]).max() <= \
                STATE_TOL * np.abs(b[:n]).max(), (e, layer)
            assert np.abs(a[n:] - b[n:]).max() <= \
                KV_ULPS * bf16_ulp(np.abs(b[n:]).max()), (e, layer)


def _global_logits(ranks, name, layout, mesh, packed, sp):
    dp, tp = mesh
    return np.concatenate([np.concatenate(
        [ranks[d * tp + m][(name, layout)][0] for m in range(tp)], axis=-1)
        for d in range(dp if not (packed or sp) else 1)], axis=0)


SERVE_LAYOUTS = [(n, lay) for n, (_a, _m, _s, ls) in SERVE.items()
                 for lay in ls]


@pytest.mark.parametrize("name,layout", SERVE_LAYOUTS)
def test_serve_step_on_a_mesh_matches_jax(runs, name, layout):
    inputs, ref, ours = runs
    arch, mesh, sp, _ = SERVE[name]
    model = _rank_model(arch, mesh, sp)
    ranks = ours[mesh]
    jlogits, jbuf = ref[(name, layout)]
    logits = _global_logits(ranks, name, layout, mesh, layout == "packed",
                            sp)
    assert logits.shape == jlogits.shape, (logits.shape, jlogits.shape)
    real = np.arange(logits.shape[-1]) < model.cfg.vocab_size
    err = np.abs(logits[:, real] - jlogits[:, real]).max()
    print(f"[mesh encdec/rwkv] {name} {layout} logits err {err:.3e}")
    assert err <= LOGIT_TOL, err
    assert (logits[:, ~real] == -1e30).all()
    units = jbuf.shape[-1]
    scratch = np.zeros(units, bool)
    scratch[units - example_pool(model, PAGES)[2]:] = True
    for d in range(mesh[0]):
        for m in range(mesh[1]):
            batch, buf0 = inputs[name][layout]["ranks"][(d, m)]
            got = ranks[d * mesh[1] + m][(name, layout)][1]
            want = jbuf[d, m]
            kv, st = _written(model, batch, units)
            rest = ~(kv | st | scratch)
            assert np.array_equal(got[rest], buf0[rest]), (d, m)
            assert np.array_equal(want[rest], buf0[rest]), (d, m)
            if kv.any():
                a, b = _bf16(got[kv]), _bf16(want[kv])
                e = np.abs(a - b).max() / bf16_ulp(np.abs(b).max())
                assert e <= KV_ULPS, (d, m, e)
            if st.any():
                _check_state(model, got, want, batch)
    sent = ranks[0][(name, layout)][2]
    assert (sent["combine"] > 0) == (model.dist.repl > 1)


@pytest.mark.parametrize("name", list(TRAIN))
def test_loss_and_grads_match_jax_on_the_mesh(runs, name):
    _, ref, ours = runs
    arch, mesh = TRAIN[name]
    r0 = ours[mesh][0][name]
    ref = ref[TRAIN_REF[name]]
    assert abs(r0["loss"] - ref["loss"]) <= LOSS_TOL, (r0["loss"],
                                                       ref["loss"])
    want, got = _flat(ref["grads"]), _flat(r0["grads"])
    assert sorted(want) == sorted(got)
    for leaf, g in want.items():
        assert got[leaf].shape == g.shape, leaf
        assert _rel(got[leaf], g) <= GRAD_TOL, (leaf, _rel(got[leaf], g))
    plan = mesh_train_bytes(build_model(_cfg(arch), Dist(dp=mesh[0],
                                                         tp=mesh[1])))
    for r in ours[mesh]:
        assert plan["params"] == r[name]["nbytes"]["params"]
        assert plan["moments"] == r[name]["nbytes"]["moments"]


@pytest.mark.parametrize("arch", [WHISPER, RWKV])
def test_checkpoint_restores_on_another_data_size(runs, arch):
    """A checkpoint the 2 x 2 Trainer wrote at step RESUME (global
    arrays) restored at 1 x 2 (another data size, the same tp) and
    continued: the losses of the uninterrupted 2 x 2 run."""
    _, _, ours = runs
    name = {WHISPER: "w-t2x2", RWKV: "r-t2x2"}[arch]
    whole = ours[(2, 2)][0][name]["hist"]
    resumed = ours[(1, 2)][0]["resume-" + name]
    assert all(r["resume-" + name] == resumed for r in ours[(1, 2)])
    np.testing.assert_allclose(resumed, whole[RESUME:], atol=RESUME_TOL)


@pytest.mark.parametrize("arch", [WHISPER, RWKV])
def test_one_by_one_mesh_is_the_single_device_path(runs, arch):
    _, _, ours = runs
    assert ours["one"][arch] == dict(serve=[True, True], loss=True,
                                     grads=True)


def _grouped_out(groups):
    """``blocks_seq._rwkv_out`` with ``ln_x`` normalising over ``groups``
    equal groups of heads, as ``groups`` model ranks do."""
    out = blocks_seq._rwkv_out

    def fn(p, y, g, b, t, norm_eps, dist=None):
        y = y.reshape(b, t, -1).to(torch.bfloat16)
        ys = y.reshape(b, t, groups, -1)
        y = rms_norm(ys, p["ln_x"].reshape(groups, -1),
                     norm_eps).reshape(b, t, -1)
        y = y * torch.nn.functional.silu(
            g.reshape(b, t, -1).float()).to(y.dtype)
        return blocks_seq.dense(y, p["w_o"])
    fn.plain = out
    return fn


def test_rwkv_ln_x_and_channel_mix_run_over_a_ranks_part(runs, monkeypatch):
    """Reference behaviours (ROADMAP queue 3): at tp > 1 RWKV6's ``ln_x``
    normalises over the rank's heads only, and the channel mix's
    ``cm_wv`` maps the rank's ``d_ff`` columns to its output columns
    only. The port's own init at 1 x 2 keeps the one-device draw's
    slices (``cm_wv``'s diagonal blocks), so its loss is the one-device
    model's with ``ln_x`` taken over 2 groups of heads and ``cm_wv``'s
    off-diagonal blocks zero: at least 3 times closer to that than to the
    one-device model's own, or to either change alone (measured: 1.2e-4
    against 1.8e-3, 1.8e-3 and 6.8e-4; the mesh sums its bf16 output
    projections over two ranks)."""
    _, _, ours = runs
    mesh = ours[(1, 2)][0]["own"]
    cfg = _cfg(RWKV)
    one = build_model(cfg)

    def loss(grouped, diagonal):
        params = one.init(0, device="cpu", master=True)
        if diagonal:
            w = params["layers"]["cm_wv"]
            ffl, dl = w.shape[1] // 2, w.shape[2] // 2
            w[:, :ffl, dl:] = 0
            w[:, ffl:, :dl] = 0
        with monkeypatch.context() as mp:
            if grouped:
                mp.setattr(blocks_seq, "_rwkv_out", _grouped_out(2))
            tok, tgt, _ = _batch(cfg)
            with torch.no_grad():
                return float(one.train_loss(params, torch.from_numpy(tok),
                                            torch.from_numpy(tgt)))
    both = loss(True, True)
    others = [loss(False, False), loss(True, False), loss(False, True)]
    print(f"[mesh encdec/rwkv] own init 1 x 2 {mesh} against both "
          f"{both}, neither / ln_x only / cm_wv only {others}")
    assert all(3 * abs(mesh - both) < abs(mesh - o) for o in others), \
        (mesh, both, others)
    assert ours["one"]["own"] == loss(False, False)


def test_rwkv_w_lora_a_copies_drift(runs):
    """Reference behaviour: ``w_lora_a`` is one draw stored with a tp axis
    (``expand_replicated``), and each copy is a leaf of its own that gets
    only its own heads' gradient: the copies' gradients differ, in the
    reference as in the port, and after one update the copies do."""
    _, ref, ours = runs
    w0, w1 = ours[(1, 2)][0]["r-t1x2"]["lora"]
    assert np.array_equal(w0[:, 0], w0[:, 1])
    assert not np.array_equal(w1[:, 0], w1[:, 1])
    for g in (ref["r-t2x2"]["grads"], ours[(1, 2)][0]["r-t1x2"]["grads"]):
        g = g["layers"]["w_lora_a"]
        assert not np.allclose(g[:, 0], g[:, 1], rtol=1e-2, atol=0)


def test_encdec_sp_attends_each_data_ranks_pages_only(runs):
    """Reference behaviour (ROADMAP queue 3): enc-dec under ``sp``
    combines its self attention over the K/V replica set only
    (``EncDecLM._serve_body``), never over "data" as the decoder does, so
    each data rank's logits attend only the self pages it holds: the two
    data ranks of the 2 x 1 ``sp`` mesh give different logits (a combine
    over "data" would make them equal), data rank 0's are the reference's
    (held above), and no combine ran."""
    _, _, ours = runs
    r0, r1 = (r[("w-2x1-sp", "decode")] for r in ours[(2, 1)])
    assert np.abs(r0[0] - r1[0]).max() > 10 * LOGIT_TOL
    assert r0[2]["combine"] == r1[2]["combine"] == 0


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
