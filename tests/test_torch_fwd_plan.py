"""The bf16 flash forward's persistent walk, checked on the CPU where the
kernel cannot run: ``flash_attention.work_tiles`` (the work tiles in the
order the kernel's blocks take them, which the kernel computes with the same
formula) and ``flash_attention.block_walk`` (the tiles of each block of the
grid of min(tiles, SMs) blocks).  Every (batch, query head, row tile) is
visited exactly once, and causal tiles longest first.  The card tests of the
kernel itself are in tests/test_torch_cuda.py.
"""

import pytest

from repro_torch.kernels import flash_attention as fa

# (B, Hq, Hkv, Sq): the prefill shapes of kimi-k2 (S=1024 and its prompt of
# 256), stablelm-12b, llama3.2-3b (a group of 3: unpaired heads),
# recurrentgemma-9b (MQA, S=3072), ragged groups of 3, and a few tiles
SHAPES = [(4, 64, 8, 1024), (4, 64, 8, 256), (4, 32, 8, 1024), (4, 24, 8, 1024),
          (1, 16, 1, 3072), (1, 6, 2, 300), (2, 12, 4, 333), (1, 3, 1, 64)]


def _keys(tile, hq, hkv, sq, causal):
    """The keys a causal tile's last row sees (Sq = Sk, no window)."""
    _, _, q0 = tile
    span = 64 if (hq // hkv) % 2 == 0 else 128
    return min(q0 + span, sq) if causal else sq


@pytest.mark.parametrize("b,hq,hkv,sq", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
def test_every_row_tile_of_every_head_once(b, hq, hkv, sq, causal):
    tiles = fa.work_tiles(b, hq, hkv, sq, causal)
    pair = (hq // hkv) % 2 == 0
    span, hpb = (64, 2) if pair else (128, 1)
    seen = []
    for bi, h0, q0 in tiles:
        assert 0 <= bi < b and 0 <= q0 < sq and q0 % span == 0 and h0 % hpb == 0
        # a pair of heads shares one KV head
        assert h0 // (hq // hkv) == (h0 + hpb - 1) // (hq // hkv)
        seen += [(bi, h, q0 // 64 + r) for h in range(h0, h0 + hpb) for r in range(span // 64)
                 if q0 + 64 * r < sq]
    want = [(bi, h, r) for bi in range(b) for h in range(hq) for r in range(-(-sq // 64))]
    assert sorted(seen) == want  # each 64-row slab of each head exactly once


@pytest.mark.parametrize("b,hq,hkv,sq", SHAPES)
def test_causal_tiles_longest_first(b, hq, hkv, sq):
    tiles = fa.work_tiles(b, hq, hkv, sq, True)
    keys = [_keys(t, hq, hkv, sq, True) for t in tiles]
    assert keys == sorted(keys, reverse=True)
    for walk in fa.block_walk(b, hq, hkv, sq, True, 132):
        ks = [_keys(t, hq, hkv, sq, True) for t in walk]
        assert ks == sorted(ks, reverse=True)


@pytest.mark.parametrize("b,hq,hkv,sq", SHAPES)
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_blocks_split_the_tiles_round_robin(b, hq, hkv, sq, sms):
    tiles = fa.work_tiles(b, hq, hkv, sq, True)
    walks = fa.block_walk(b, hq, hkv, sq, True, sms)
    assert len(walks) == min(len(tiles), sms) and all(walks)
    assert sorted(t for w in walks for t in w) == sorted(tiles)
    for p, walk in enumerate(walks):
        assert walk == tiles[p::len(walks)]
    # the blocks' loads differ by at most one tile
    assert max(map(len, walks)) - min(map(len, walks)) <= 1
