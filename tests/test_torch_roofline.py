"""The roofline (``roofline/analysis.py``) against the reference's, run
live: the HLO collective parser on the reference's own fixtures
(``tests/test_roofline.py``), the roofline terms, ``analytic_flops`` for
every config and input shape, ``recommend_execution`` and the branch
``improvement_hint`` takes; and the port's own collective log.  Every
number equals the reference's exactly."""
import itertools
import textwrap

import pytest

from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import mesh
from repro_torch.roofline import analysis as port
from test_torch_reference import load_reference

HLO = textwrap.dedent("""
    HloModule test

    %inner_body (p: (s32[], f32[8])) -> (s32[], f32[8]) {
      %ag1 = f32[64,4]{1,0} all-gather(%x), replica_groups=[4,4]<=[16]
      ROOT %t = (s32[], f32[8]) tuple(%i, %y)
    }

    %outer_body (p: (s32[], f32[8])) -> (s32[], f32[8]) {
      %ar1 = f32[32]{0} all-reduce(%g), replica_groups={{0,1},{2,3}}
      %w = (s32[], f32[8]) while(%t0), condition=%cond, body=%inner_body, backend_config={"known_trip_count":{"n":"3"}}
      %cp = f32[16]{0} collective-permute(%g), source_target_pairs={{0,8},{1,9}}
      ROOT %t2 = (s32[], f32[8]) tuple(%i, %y)
    }

    ENTRY %main (a: f32[8]) -> f32[8] {
      %big = bf16[128,128]{1,0} all-gather(%a), replica_groups=[2,8]<=[16]
      %rs = (f32[4,4], bf16[8]) reduce-scatter(%a), replica_groups=[4,4]<=[4,4]T(1,0)
      %w0 = (s32[], f32[8]) while(%t), condition=%c, body=%outer_body, backend_config={"known_trip_count":{"n":"5"}}
      %w1 = (s32[], f32[8]) while(%t), condition=%c, body=%inner_body
      %s = f32[8] all-reduce-start(%a), replica_groups={{0,1}}
      %d = f32[8] all-reduce-done(%s)
      ROOT %r = f32[8] add(%a, %a)
    }
""")


def ref():
    return load_reference().roofline


@pytest.mark.parametrize("shape", ["f32[64,4]", "bf16[128,128]",
                                   "(f32[2,2], bf16[4])", "pred[]",
                                   "token[] f32[3]", "s4[7,3]"])
def test_shape_bytes(shape):
    assert port._shape_bytes(shape) == ref()._shape_bytes(shape)


@pytest.mark.parametrize("pod_size", [0, 2, 4, 8, 16])
def test_collective_bytes_from_hlo(pod_size):
    want = ref().collective_bytes_from_hlo(HLO, pod_size=pod_size)
    assert port.collective_bytes_from_hlo(HLO, pod_size=pod_size) == want
    assert want["total"] > 0 and want["counts"]["all-gather"] >= 16


@pytest.mark.parametrize("text,pod", [
    ("all-gather(%x), replica_groups=[4,4]<=[16]", 8),
    ("all-gather(%x), replica_groups=[2,8]<=[16]", 4),
    ("all-gather(%x), replica_groups=[4,4]<=[4,4]T(1,0)", 4),
    ("all-reduce(%g), replica_groups={{0,9}}", 8),
    ("all-reduce(%g), replica_groups={{0,1},{8,9}}", 8),
    ("collective-permute(%x), source_target_pairs={{0,8}}", 8),
    ("collective-permute(%x), source_target_pairs={{0,1},{8,9}}", 8),
    ("all-reduce(%g)", 8)])
def test_crosses_pods(text, pod):
    assert port._crosses_pods(text, pod) == ref()._crosses_pods(text, pod)


@pytest.mark.parametrize("args", [
    (1e12, 1e9, 1e8, 1), (1e9, 1e9, 1e12, 1), (1e9, 1e13, 1e9, 4),
    (0.0, 0.0, 0.0, 1)])
def test_roofline_terms_and_dominance(args):
    consts = (mesh.PEAK_FLOPS_BF16, mesh.HBM_BW, mesh.NVLINK_BW)
    got = port.roofline_terms(*args, *consts)
    assert got == ref().roofline_terms(*args, *consts)
    assert port.dominant_term(got) == ref().dominant_term(got)


def test_the_card_constants():
    """The H100 80GB HBM3 datasheet figures, in place of the TPU's."""
    assert (mesh.PEAK_FLOPS_BF16, mesh.PEAK_FLOPS_F32, mesh.HBM_BW,
            mesh.NVLINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    assert not hasattr(mesh, "ICI_BW")


@pytest.mark.parametrize("arch", list_archs())
def test_analytic_flops_every_config_and_shape(arch):
    rc = load_reference().configs
    for name, shape in INPUT_SHAPES.items():
        for n_active in (1, 494_032_768, 72_000_000_000):
            assert port.analytic_flops(get_config(arch), shape, n_active) == \
                ref().analytic_flops(rc.get_config(arch),
                                     rc.INPUT_SHAPES[name], n_active), name


@pytest.mark.parametrize("G,D,avail", [(2, 4, 8), (6, 4, 8), (5, 4, 4),
                                       (6, 4, 1), (20, 10, 2), (3, 7, 6)])
def test_recommend_execution(G, D, avail):
    for compute_s, channel_s in [(None, None), (0.15, 0.01), (0.15, 0.001),
                                 (0.02, 0.2), (0.1, None)]:
        kw = dict(avail=avail, compute_s=compute_s, channel_s=channel_s)
        assert port.recommend_execution(G, D, **kw) == \
            ref().recommend_execution(G, D, **kw)


def test_improvement_hint_takes_the_reference_branch():
    """The port's sentences drop the reference's TPU measurements, so
    the sentences differ; the records they group together do not."""
    terms = {"compute_s": 1.0, "memory_s": 2.0, "collective_s": 0.5}
    records = [{"roofline": terms, "shape": "decode_32k", "arch": "x"}]
    for dom, shape, arch in itertools.product(
            ("compute", "memory", "collective"),
            ("train_4k", "prefill_32k", "decode_32k", "long_500k"),
            ("qwen2-0.5b", "qwen2-moe-a2.7b", "deepseek-v2-236b")):
        records.append({"dominant": dom, "shape": shape, "arch": arch,
                        "roofline": terms})
    got = [port.improvement_hint(r) for r in records]
    want = [ref().improvement_hint(r) for r in records]
    pairs = set(zip(got, want))
    assert len(pairs) == len(set(got)) == len(set(want)) == 7
    for text in got:
        for word in ("TPU", "XLA", "measured", "§Perf"):
            assert word not in text


def test_summarize_combo():
    rec = {"arch": "qwen2-0.5b", "shape": "train_4k", "mesh": "1x1",
           "roofline": port.roofline_terms(1e12, 1e9, 1e8, 1, 989e12,
                                           3.35e12, 450e9),
           "model_flops_ratio": 0.5}
    assert port.summarize_combo(rec) == ref().summarize_combo(rec)


def test_collective_bytes_from_log():
    """The port's own count: the HLO dict's keys and meanings from
    ``launch/mesh.py``'s records."""
    log = mesh.CollectiveLog()
    log.records += [("all-reduce", 400, (0, 1)), ("all-gather", 800, (0, 1)),
                    ("all-reduce", 40, (0,)), ("all-gather", 64, (0, 1, 2, 3))]
    out = port.collective_bytes_from_log(log, pod_size=2)
    hlo = port.collective_bytes_from_hlo("")
    assert set(hlo) <= set(out)
    assert out["all-reduce"] == 440 and out["all-gather"] == 864
    assert out["total"] == 1304
    assert out["counts"]["all-reduce"] == 2
    assert out["counts"]["all-gather"] == 2
    assert out["cross_pod"] == 64       # only the 4-rank group spans pods
    assert port.collective_bytes_from_log(log.records, 1)["cross_pod"] == \
        1264
    assert port.collective_bytes_from_log([])["total"] == 0
