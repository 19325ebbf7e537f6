"""Network-graph artifact tests (reference: training/networks.py:148-152
draws the caffe net next to the prototxt for every experiment)."""
import os

import pytest

from reflectance_filtering.models.draw import (network_graph,
                                                   render_network_graph)
from reflectance_filtering.models.networks import NetworkConfig

CONFIGS = [
    NetworkConfig(),                                        # flagship
    NetworkConfig(network_type="cascadeSkipLayers", num_layers=3),
    NetworkConfig(network_type="convStaticWithSigmoid", num_layers=2,
                  kernel_pad=1),
    NetworkConfig(network_type="convStatic", num_layers=2),
    NetworkConfig(network_type="convStatic", num_layers=0),
    NetworkConfig(network_type="convStaticSkipLayers", num_layers=0),
    NetworkConfig(network_type="simpleConvolutionsRelu", num_layers=2,
                  kernel_pad=1),
    NetworkConfig(network_type="convIncreasing", num_layers=3,
                  kernel_pad=1),
    NetworkConfig(network_type="uNet", num_layers=1, kernel_pad=1),
    NetworkConfig(use_batch_normalization=True),
]


@pytest.mark.parametrize("cfg", CONFIGS,
                         ids=lambda c: "{}_n{}".format(c.network_type,
                                                       c.num_layers))
def test_graph_is_connected_dag(cfg):
    nodes, edges = network_graph(cfg)
    ids = [nid for nid, *_ in nodes]
    assert len(ids) == len(set(ids))
    for a, b in edges:
        assert a in ids and b in ids
    # every node except the data input has an in-edge; data has none
    targets = {b for _, b in edges}
    for nid in ids:
        assert (nid in targets) == (nid != "data")
    # the head blob is reachable from data
    adj = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    seen, stack = set(), ["data"]
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(adj.get(cur, ()))
    assert "RS_est" in seen
    assert seen == set(ids)  # no orphaned nodes


def test_skip_layer_concat_fanin():
    nodes, edges = network_graph(NetworkConfig())  # 5-layer flagship
    fanin = [a for a, b in edges if b == "concat"]
    assert sorted(fanin) == ["conv0", "conv1", "conv2", "conv3", "conv4"]


def test_render_writes_png(tmp_path):
    p = render_network_graph(NetworkConfig(), str(tmp_path / "net.png"))
    assert os.path.getsize(p) > 1000
    with open(p, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
