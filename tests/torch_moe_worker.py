"""The MoE language model of ``examples/moe/train_moe_lm.py`` written
against the port, and one rank of the expert-parallel launch
(``python -m mxnet_tpu_torch.tools.launch -n 4 --launcher local -p PORT
python tests/torch_moe_worker.py OUT moe4``).

The launch trains the narrow LM through ``DataParallelTrainer`` with
``gluon_moe_param_spec_fn`` on ``{dp:2, ep:2}`` and on ``{rep:2, dp:2,
ep:1}`` (the same ``{dp:2}`` run twice side by side: a mesh spans every
rank) from ``OUT/moe-weights.npz`` over the same global batches, and
writes each rank's losses, its masters' and states' shapes, the
collectives of every step and the full parameters after the last step.
"""
import json
import os
import sys
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_mesh_worker as mw  # noqa: E402

VOCAB, D_MODEL, LAYERS, HEADS, EXPERTS, D_HIDDEN = 64, 32, 2, 4, 4, 64
BATCH, SEQ, STEPS, LR, AUX_WEIGHT = 16, 16, 3, 3e-3, 0.01
MESHES = (("ep2", {"dp": 2, "ep": 2}), ("ep1", {"rep": 2, "dp": 2, "ep": 1}))


def lm_classes(mx):
    """``(MoEDecoderLayer, MoETransformerLM)`` over the port's gluon, as
    the example writes them over the JAX package's."""
    gluon = mx.gluon

    class MoEDecoderLayer(gluon.HybridBlock):
        def __init__(self, d_model, n_heads, n_experts, d_hidden, top_k=1,
                     **kw):
            super().__init__(**kw)
            self._h = n_heads
            self.norm1 = gluon.nn.LayerNorm()
            self.norm2 = gluon.nn.LayerNorm()
            self.in_weight = self.params.get("in_weight",
                                             shape=(3 * d_model, d_model))
            self.in_bias = self.params.get("in_bias", shape=(3 * d_model,),
                                           init="zeros")
            self.out_weight = self.params.get("out_weight",
                                              shape=(d_model, d_model))
            self.out_bias = self.params.get("out_bias", shape=(d_model,),
                                            init="zeros")
            self.moe = gluon.contrib.nn.MoEFFN(n_experts, d_model, d_hidden,
                                               top_k=top_k)

        def hybrid_forward(self, F, x, in_weight, in_bias, out_weight,
                           out_bias):
            h = self.norm1(x)
            att = F.multihead_attention(h, h, h, in_weight, in_bias,
                                        out_weight, out_bias,
                                        num_heads=self._h, causal=True)
            x = x + att
            y, aux = self.moe(self.norm2(x))
            return x + y, aux

    class MoETransformerLM(gluon.HybridBlock):
        def __init__(self, vocab, d_model=64, n_layers=2, n_heads=4,
                     n_experts=4, d_hidden=128, top_k=1, **kw):
            super().__init__(**kw)
            self.embed = gluon.nn.Embedding(vocab, d_model)
            self.layers = []
            for i in range(n_layers):
                layer = MoEDecoderLayer(d_model, n_heads, n_experts,
                                        d_hidden, top_k=top_k)
                setattr(self, f"layer{i}", layer)
                self.layers.append(layer)
            self.head = gluon.nn.Dense(vocab, flatten=False)

        def hybrid_forward(self, F, tokens):
            x = self.embed(tokens)
            aux_total = None
            for layer in self.layers:
                x, aux = layer(x)
                aux_total = aux if aux_total is None else aux_total + aux
            return self.head(x), aux_total

    return MoEDecoderLayer, MoETransformerLM


def synthetic_batch(rng, bs, seq_len, vocab):
    """The example's batches: arithmetic sequences mod ``vocab``."""
    start = rng.randint(0, vocab, (bs, 1))
    step = rng.randint(1, 5, (bs, 1))
    toks = (start + step * np.arange(seq_len + 1)[None, :]) % vocab
    return toks[:, :-1].astype(np.float32), toks[:, 1:].astype(np.float32)


def batches():
    rng = np.random.RandomState(0)
    return [synthetic_batch(rng, BATCH, SEQ, VOCAB) for _ in range(STEPS)]


class LMWithAux:
    """The JAX test's loss: the mean cross-entropy plus the weighted aux
    loss."""

    def __init__(self, mx):
        self.sce = mx.gluon.loss.SoftmaxCrossEntropyLoss(axis=-1)

    def __call__(self, out, label):
        logits, aux = out
        return self.sce(logits, label).mean() + AUX_WEIGHT * aux.sum()


def narrow_lm(mx, ctx, weights=None, top_k=1):
    """The narrow LM on ``ctx``, its shapes finished by a forward, with
    ``weights`` ({structural name: array}) loaded when given."""
    _, LM = lm_classes(mx)
    net = LM(VOCAB, d_model=D_MODEL, n_layers=LAYERS, n_heads=HEADS,
             n_experts=EXPERTS, d_hidden=D_HIDDEN, top_k=top_k)
    net.initialize(mx.init.Xavier(), ctx=ctx)
    with mx.autograd.pause():
        net(mx.nd.array(np.zeros((2, SEQ), np.float32), ctx=ctx))
    if weights is not None:
        mx.load_numpy_params(net, weights)
    return net


def case_moe(mx, out):
    from mxnet_tpu_torch.parallel import DataParallelTrainer
    from mxnet_tpu_torch.parallel import mesh as M
    from mxnet_tpu_torch.parallel.moe import gluon_moe_param_spec_fn

    z = np.load(os.path.join(mw.OUT_DIR, "moe-weights.npz"))
    weights = {k: z[k] for k in z.files}
    data = batches()
    for label, shape in MESHES:
        mx.random.seed(0)
        net = narrow_lm(mx, mx.cpu(), weights)
        mesh = M.make_mesh(shape)
        tr = DataParallelTrainer(net, LMWithAux(mx), "adam",
                                 {"learning_rate": LR}, mesh=mesh,
                                 param_spec_fn=gluon_moe_param_spec_fn(mesh))
        tr.build(data[0][0])
        losses, comm = [], []
        for x, y in data:
            M.reset_comm_stats()
            losses.append(float(tr.step(x, y).asnumpy()))
            comm.append(M.comm_stats())
        out.note(label, "losses", losses)
        out.note(label, "comm", comm)
        out.note(label, "names", [n for n, _ in tr._named])
        out.note(label, "specs", [list(sp) for sp in tr._specs])
        out.note(label, "local", list(tr._local))
        out.note(label, "full_shapes", [list(s) for s in tr._full_shapes])
        out.note(label, "shapes", [list(p.shape) for p in tr._params])
        out.note(label, "state_shapes", [
            [list(t.shape) for t in st] if st else None
            for st in tr._states])
        for i, v in enumerate(tr._full_values()):
            out.put(label, f"p{i}", v.detach().numpy())


def main(out_dir, mode):
    mw.OUT_DIR = out_dir
    import torch

    torch.set_num_threads(1)
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.parallel import dist

    dist.init()
    rank = dist.rank()
    out = mw.Out()
    out.note("run", "backend", dist.backend())
    out.note("run", "size", dist.num_workers())
    failed = None
    try:
        {"moe4": case_moe}[mode](mx, out)
    except Exception:  # noqa: BLE001 - reported, then the rank fails
        failed = traceback.format_exc()
    np.savez(os.path.join(out_dir, f"{mode}-rank{rank}.npz"), **out.arrays)
    with open(os.path.join(out_dir, f"{mode}-rank{rank}.json"), "w") as f:
        json.dump(out.meta, f)
    if failed:
        print(failed, file=sys.stderr)
        return 1
    dist.barrier()
    dist.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], sys.argv[2]))
