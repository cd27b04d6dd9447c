"""``--layers`` on the port's serving entry points (generate, serve,
quality_eval), on the CPU: a checkpoint that ``llama_train --layers 1``
wrote is served at that depth by each entry point, which restores the
checkpoint's own params; without ``--layers`` the restore names the
mismatch instead of loading a model of the preset's depth."""

import json

import numpy as np
import pytest
import torch

from pytorch_operator_tpu_torch.checkpoint import CheckpointManager
from pytorch_operator_tpu_torch.data import pack_arrays
from pytorch_operator_tpu_torch.models import llama as port_llama
from pytorch_operator_tpu_torch.serving import Spool
from pytorch_operator_tpu_torch.workloads import generate, llama_train, quality_eval, serve

LAYERS = 1  # the tiny preset has 2


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny run at ``LAYERS`` layers on a learnable byte stream, its
    checkpoint directory and packed eval file."""
    td = tmp_path_factory.mktemp("layers")
    start = np.random.default_rng(0).integers(0, 256, (40, 1))
    toks = ((start + np.arange(32)[None]) % 256).astype(np.int32)
    pack_arrays(td / "train.bin", {"tokens": toks[:32]})
    pack_arrays(td / "eval.bin", {"tokens": toks[32:]})
    ck = td / "ck"
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUJOB_CHECKPOINT_DIR", str(ck))
        r = llama_train.run(
            config="tiny", n_layers=LAYERS, batch_size=4, seq_len=32, steps=2, warmup=1,
            lr=1e-2, data_file=str(td / "train.bin"), checkpoint_every=3, device="cpu",
            log=lambda m: None,
        )
    _, params = CheckpointManager(ck, create=False).restore_subtree("params")
    assert r["n_layers"] == LAYERS and not any(k.startswith(f"layers.{LAYERS}.") for k in params)
    return {"ck": ck, "eval": td / "eval.bin", "step": r["end_step"], "params": params}


def _rollout(params, prompt, new):
    """The single-stream greedy rollout on ``params`` at ``LAYERS`` layers."""
    cfg = port_llama.llama_tiny(decode=True, max_decode_len=48, n_layers=LAYERS)
    model = port_llama.Llama(cfg)
    model.load_state_dict(params)
    model.cast_matmul_weights_().requires_grad_(False).eval()
    toks, _ = generate.make_generate(model, max_new_tokens=new)(
        generate.init_cache(model, 1), torch.tensor([prompt]), torch.Generator()
    )
    return toks[0].tolist()


@pytest.mark.parametrize("entry", ["generate", "serve", "quality_eval"])
def test_layers_serves_a_shallower_checkpoint(entry, trained, tmp_path, capsys):
    ck = str(trained["ck"])
    if entry == "generate":
        assert generate.main([
            "--config", "tiny", "--layers", str(LAYERS), "--restore", ck, "--device", "cpu",
            "--batch-size", "2", "--prompt-len", "8", "--max-new-tokens", "4", "--json",
        ]) == 0
        r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert r["restored_step"] == trained["step"]
        assert r["flash_launches_per_generate"] == 0  # the tiny preset attends densely on the CPU
    elif entry == "serve":
        sp = Spool(tmp_path / "spool")
        prompt = [5, 9, 2, 7, 1]
        rid = sp.submit(prompt=prompt, max_new_tokens=6)
        assert serve.main([
            "--config", "tiny", "--layers", str(LAYERS), "--restore", ck, "--spool", str(sp.root),
            "--device", "cpu", "--slots", "2", "--chunk", "8", "--block", "4",
            "--max-decode-len", "48", "--max-requests", "1", "--idle-timeout", "60", "--json",
        ]) == 0
        stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert stats["served"] == 1 and stats["restored_step"] == trained["step"]
        assert sp.wait_response(rid, timeout=5)["tokens"] == _rollout(trained["params"], prompt, 6)
    else:
        assert quality_eval.main([
            "--config", "tiny", "--layers", str(LAYERS), "--restore", ck, "--eval-file",
            str(trained["eval"]), "--eval-batches", "2", "--batch-size", "4", "--chunk", "8",
            "--drift-tokens", "8", "--drift-window", "4", "--drift-prompt", "8", "--device", "cpu",
        ]) == 0
        r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert r["restored_step"] == trained["step"] and r["eval_rows"] == 8
        n = sum(t.numel() for t in trained["params"].values())
        assert r["params_m"] == round(n / 1e6, 1)
        assert all(np.isfinite(r[f"{v}_eval_loss"]) for v in ("fp", "int8", "int8_kv8"))


@pytest.mark.parametrize("entry", ["generate", "serve", "quality_eval"])
def test_preset_depth_refuses_a_shallower_checkpoint(entry, trained, tmp_path):
    """Without ``--layers`` the preset's 2 layers meet a 1-layer checkpoint:
    the restore fails by name, at the first missing tensor."""
    ck = str(trained["ck"])
    run = {
        "generate": lambda: generate.run(config="tiny", restore=ck, batch_size=2, prompt_len=8,
                                         max_new_tokens=4, device="cpu", log=lambda m: None),
        "serve": lambda: serve.run(config="tiny", restore=ck, spool_dir=str(tmp_path / "spool"),
                                   max_requests=1, idle_timeout=1, device="cpu", log=lambda m: None),
        "quality_eval": lambda: quality_eval.run(
            config="tiny", restore=ck, eval_file=str(trained["eval"]), batch_size=4,
            drift_tokens=8, drift_window=4, drift_prompt=8, device="cpu", log=lambda m: None),
    }[entry]
    with pytest.raises(ValueError, match=r"--config tiny at 2 layers: first mismatch at layers\.1\."):
        run()
