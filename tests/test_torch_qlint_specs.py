"""The port's ``launch/specs.py`` and qlint trace specs against the JAX
package's: every reduced config's cells, input and cache shapes and
dtypes, concrete tokens bit for bit, and the trace names, metas and
parameter paths of ``registry_trace_specs``."""
import numpy as np
import pytest

from torch_qlint_cases import jax_leak_check  # noqa: F401

from repro_torch.analysis import traces as T
from repro_torch.configs.registry import REDUCED
from repro_torch.launch import specs


def _sig(tree):
    """{path: (shape, dtype name)} of a flat dict of arrays / tensors."""
    return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
            for k, v in tree.items()}


def test_specs_match_jax_for_every_reduced_config(jax_leak_check):
    from repro.configs.registry import REDUCED as JREDUCED
    from repro.launch import specs as jspecs
    assert list(specs.SHAPES) == list(jspecs.SHAPES)
    for name, cfg in REDUCED.items():
        jcfg = JREDUCED[name]
        for key, shape in specs.SHAPES.items():
            jshape = jspecs.SHAPES[key]
            assert shape.__dict__ == jshape.__dict__
            assert specs.cell_is_skipped(cfg, shape) == \
                jspecs.cell_is_skipped(jcfg, jshape), (name, key)
        if cfg.family == "efficientvit":
            continue
        for seq in (8, 4096):
            assert _sig(specs.train_inputs(cfg, 2, seq)) == \
                _sig(jspecs.train_inputs(jcfg, 2, seq)), (name, seq)
            inp, cache = specs.prefill_inputs(cfg, 2, seq)
            jinp, jcache = jspecs.prefill_inputs(jcfg, 2, seq)
            assert _sig(inp) == _sig(jinp), (name, seq)
            assert _sig(cache) == _sig(jcache), (name, seq)
            cache, tok = specs.decode_inputs(cfg, 2, seq)
            jcache, jtok = jspecs.decode_inputs(jcfg, 2, seq)
            assert _sig(cache) == _sig(jcache), (name, seq)
            assert _sig({"t": tok}) == _sig({"t": jtok})
            assert tok.device.type == "meta"


def test_concrete_tokens_equal_bit_for_bit(jax_leak_check):
    from repro.configs.registry import REDUCED as JREDUCED
    from repro.launch import specs as jspecs
    for name in ("qwen1.5-0.5b", "whisper-large-v3", "internvl2-2b"):
        cfg, jcfg = REDUCED[name], JREDUCED[name]
        inp = specs.train_inputs(cfg, 2, 40, concrete=True)
        jinp = jspecs.train_inputs(jcfg, 2, 40, concrete=True)
        assert _sig(inp) == _sig(jinp)
        for k in inp:
            np.testing.assert_array_equal(
                inp[k].float().numpy(), np.asarray(jinp[k], np.float32))
        cache, tok = specs.decode_inputs(cfg, 2, 16, concrete=True)
        jcache, jtok = jspecs.decode_inputs(jcfg, 2, 16, concrete=True)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(cache["lengths"].numpy(),
                                      np.asarray(jcache["lengths"]))


@pytest.mark.parametrize("arch", ["efficientvit-b1-r224", "qwen1.5-0.5b"])
def test_trace_names_metas_and_paths_match_jax(arch, jax_leak_check):
    from repro.analysis import traces as jT
    jspecs = list(jT.registry_trace_specs(arch))
    ours = list(T.qlint_trace_specs(arch, device="cpu"))
    assert [s[2] for s in ours] == [s[2] for s in jspecs]
    for (fn, args, name, meta, loop), (_, jargs, _, jmeta) in zip(
            ours, jspecs):
        assert meta == jmeta, name
        assert loop == ("decode" if name.endswith("/decode") else None)
        assert T.param_paths(args) == jT.param_paths(jargs), name
        # the inputs (and cache) beside the tree: JAX's shapes and dtypes
        for ours_in, jax_in in zip(args[1:], jargs[1:]):
            if not isinstance(ours_in, dict):
                ours_in, jax_in = {"x": ours_in}, {"x": jax_in}
            assert _sig(ours_in) == _sig(jax_in), name
