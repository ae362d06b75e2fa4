"""Quickstart through the PyTorch port: train a reduced deepseek-7b-family
model end to end with the production stack (the data pipeline, AdamW and
its cosine schedule, checkpoints, the straggler watchdog), then serve
four requests from it.

  PYTHONPATH=src python examples/quickstart_torch.py               # the GPU
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The same model, steps and requests as ``examples/quickstart.py`` of the JAX
package. On the GPU the norms run the rmsnorm kernels and their backward;
attention is the plain ``"full"`` core, as the reference's is here.
"""
import argparse
import tempfile

from repro_torch.configs import RunConfig, get_arch
from repro_torch.data.pipeline import ShardedLoader, SyntheticLMDataset
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import init_train_state, make_train_step

RUN = RunConfig(attn_impl="full", remat="nothing", compute_dtype="float32")
STEPS, CKPT_EVERY, BATCH, SEQ, LR = 300, 100, 16, 64, 3e-3
SLOTS, MAX_LEN, MAX_NEW = 4, 64, 12
PROMPTS = [[1 + rid, 7, 42] for rid in range(4)]


def config():
    """deepseek-7b reduced: d_model 128, 4 layers, vocabulary 512, d_ff
    256."""
    return get_arch("deepseek-7b").reduced(d_model=128, n_layers=4,
                                           vocab_size=512, d_ff=256)


def build(device=None, seed=0) -> Model:
    """The model on `device` (None: the GPU), weights drawn from `seed`."""
    return Model(config(), RUN, device=device).init(seed=seed)


def train_and_serve(model: Model, steps: int = STEPS,
                    ckpt_every: int = CKPT_EVERY, ckpt_dir=None, log=print):
    """Train `model` from the weights it holds for `steps` steps of BATCH
    x SEQ synthetic tokens, a checkpoint every `ckpt_every` steps under
    `ckpt_dir` (a new temporary directory if None), then serve the four
    PROMPTS greedily on SLOTS slots -> (the loop's report, the finished
    requests by id)."""
    acfg = AdamWConfig(lr=LR)
    state = init_train_state(model, None, acfg)
    step = make_train_step(model, acfg, total_steps=steps)
    loader = ShardedLoader(SyntheticLMDataset(model.cfg.vocab_size), BATCH,
                           SEQ)
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="quickstart_ckpt_")
    state, report = train_loop(
        state, step, loader,
        LoopConfig(total_steps=steps, ckpt_every=ckpt_every,
                   ckpt_dir=ckpt_dir, log_every=25), log=log)
    log(f"\nloss: {report.losses[0]:.3f} -> {report.losses[-1]:.3f} over "
        f"{report.final_step} steps (checkpoints in {ckpt_dir})")
    engine = ServeEngine(model, slots=SLOTS, max_len=MAX_LEN)
    for rid, prompt in enumerate(PROMPTS):
        engine.submit(Request(rid, prompt=list(prompt),
                              max_new_tokens=MAX_NEW))
    done = sorted(engine.run(), key=lambda r: r.rid)
    for r in done:
        log(f"request {r.rid}: {r.prompt} -> {r.out_tokens}")
    return report, done


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--ckpt-dir", default=None,
                    help="where the checkpoints go (default: a new "
                         "temporary directory)")
    args = ap.parse_args(argv)
    train_and_serve(build(args.device), steps=args.steps,
                    ckpt_dir=args.ckpt_dir)


if __name__ == "__main__":
    main()
