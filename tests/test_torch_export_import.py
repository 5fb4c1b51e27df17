"""The port's ``utils/export.py`` and ``utils/torch_import.py`` against the
JAX package's: the viewer JSON equal after ``json.loads``; a reference
state_dict (built by walking the JAX ``init_params`` tree through the JAX
package's ``flax_path_to_torch_key``, kernels transposed to torch's
[out, in]) imported by the port equal bit for bit to
``state_dict_from_flax`` of the JAX import; a missing and a surplus key
raise ``KeyError`` as in JAX."""

import enum
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_neural_network_for_radar_perception_torch.config import config as TC
from graph_neural_network_for_radar_perception_torch.infer.pipeline import (
    FrameDetections,
)
from graph_neural_network_for_radar_perception_torch.models.gnn import RadarGNN
from graph_neural_network_for_radar_perception_torch.utils import export as TE
from graph_neural_network_for_radar_perception_torch.utils import torch_import as TI
from graph_neural_network_for_radar_perception_torch.utils.convert import (
    state_dict_from_flax,
)
from graph_neural_network_for_radar_perception_tpu.config import config as JC
from graph_neural_network_for_radar_perception_tpu.models.gnn import RadarGNN as JaxGNN
from graph_neural_network_for_radar_perception_tpu.utils import export as JE
from graph_neural_network_for_radar_perception_tpu.utils import torch_import as JI
from torch_port_fixtures import one_torch_thread  # noqa: F401  (autouse)


class _Label(enum.Enum):
    CAR = 0
    PEDESTRIAN = 1


@pytest.mark.parametrize("schema", ["SemSeg", "InstSeg"])
@pytest.mark.parametrize("translation", ["ints", "enums"])
def test_per_point_predictions_json_equals_jax(tmp_path, schema, translation):
    if translation == "ints":
        table = {0: "CAR", 11: None, 5: 3}
    else:
        table = {_Label.CAR: _Label.PEDESTRIAN, 7: _Label.CAR, 11: None}
    preds = ({b"uuid-1": 3, "uuid-2": 0} if schema == "SemSeg"
             else {b"uuid-1": [3, 0], "uuid-2": [0, 2]})
    got = TE.per_point_predictions_to_json(
        preds, str(tmp_path / "port.json"), table, getattr(TE.PredictionFileSchemas, schema))
    want = JE.per_point_predictions_to_json(
        preds, str(tmp_path / "jax.json"), table, getattr(JE.PredictionFileSchemas, schema))
    assert got == want
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())
    assert [s.value for s in TE.PredictionFileSchemas] == [s.value for s in JE.PredictionFileSchemas]


def _detections(rng, n=9):
    c = 4
    return FrameDetections(
        node_class=rng.integers(0, 7, n).astype(np.int32),
        node_score=rng.random(n).astype(np.float32),
        centers=rng.normal(size=(n, 2)).astype(np.float32),
        link_class=rng.integers(0, 2, 5),
        node2cluster=rng.integers(0, c, n).astype(np.int32),
        num_clusters=c,
        cluster_mu=rng.normal(size=(c, 2)).astype(np.float32),
        cluster_sigma=rng.normal(size=(c, 2, 2)).astype(np.float32),
        cluster_size=rng.integers(1, 5, c),
        cluster_class=rng.integers(0, 7, c).astype(np.int32),
        xy=rng.normal(size=(n, 2)).astype(np.float32),
    )


@pytest.mark.parametrize("translation", [None, {0: "CAR", 6: None}])
def test_export_frame_detections_equals_jax(tmp_path, rng, translation):
    det = _detections(rng)
    uuids = [f"u{i}".encode() for i in range(9)]
    got = TE.export_frame_detections(det, uuids, str(tmp_path / "port.json"), translation)
    want = JE.export_frame_detections(det, uuids, str(tmp_path / "jax.json"), translation)
    assert got == want
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        (tmp_path / "jax.json").read_text())


def _jax_params(jcfg):
    from graph_neural_network_for_radar_perception_tpu.data.pipeline import (
        SyntheticRadarDataset,
        pad_frame,
    )

    g, lbl = pad_frame(SyntheticRadarDataset(jcfg, seed=5, num_objects=2).sample_frame(), jcfg)
    g = jax.tree.map(jnp.asarray, g)
    return JaxGNN(jcfg).init(jax.random.key(0), g, jnp.asarray(lbl.node2cluster),
                             jcfg.max_clusters, jnp.asarray(lbl.cluster_mask))["params"]


def _reference_state_dict(params):
    """The reference's layout: every JAX leaf under its torch key, ``pred.``
    prefixed, kernels transposed to [out, in]."""
    sd = {}
    for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
        parts = tuple(p.key for p in path)
        v = np.asarray(v)
        if parts[-1] == "kernel" and v.ndim == 2:
            v = v.T
        sd["pred." + JI.flax_path_to_torch_key(parts)] = torch.from_numpy(v.copy())
    return sd


@pytest.fixture(scope="module", params=["tiny", "shipped"])
def reference(request):
    overrides = {}
    if request.param == "tiny":
        jcfg, cfg = JC.tiny_test_config(), TC.tiny_test_config()
    else:
        overrides = dict(max_nodes=64, max_clusters=32)  # widths as shipped
        jcfg, cfg = JC.GNNConfig(**overrides), TC.GNNConfig(**overrides)
    params = _jax_params(jcfg)
    return cfg, params, _reference_state_dict(params)


def test_import_equals_jax_import(reference):
    cfg, params, sd = reference
    want = state_dict_from_flax(jax.tree.map(np.asarray, JI.import_torch_checkpoint(params, sd)))
    got = TI.import_torch_checkpoint(RadarGNN(cfg).state_dict(), sd)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    RadarGNN(cfg).load_state_dict(got)  # the port's model takes it as is


def test_reference_keys_are_the_jax_grammar(reference):
    """Every port key maps to a key of the reference layout, one to one."""
    cfg, _, sd = reference
    keys = [TI.reference_key(k) for k in RadarGNN(cfg).state_dict()]
    assert sorted(keys) == sorted(k[5:] for k in sd)


def test_missing_and_surplus_keys_raise(reference):
    cfg, params, sd = reference
    template = RadarGNN(cfg).state_dict()
    missing = dict(sd)
    del missing["pred.predict_offset.pred_offsets.head.1.bias"]
    for fn in (lambda s: TI.import_torch_checkpoint(template, s),
               lambda s: JI.import_torch_checkpoint(params, s)):
        with pytest.raises(KeyError, match="not in checkpoint"):
            fn(missing)
        with pytest.raises(KeyError, match="not consumed"):
            fn(dict(sd, **{"pred.extra.weight": torch.zeros(2)}))


def test_load_reference_checkpoint(tmp_path, reference):
    cfg, params, sd = reference
    path = tmp_path / "ref.pt"
    torch.save(sd, path)
    got = TI.load_reference_checkpoint(RadarGNN(cfg).state_dict(), str(path))
    want = TI.import_torch_checkpoint(RadarGNN(cfg).state_dict(), sd)
    assert all(torch.equal(got[k], want[k]) for k in want)
