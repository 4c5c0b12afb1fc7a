"""medvill_torch.ops.bert_adam on the CPU: the launch table the two CUDA
kernels walk (offsets, ragged tails, alignment, the rebuild on an address
change), the plain path that CPU parameters take (the foreach chain, no
kernel launch, the update the chain made before the kernel existed), and
the module on a host without nvcc.  The kernels themselves are held
against the chain on the card, in tests/test_torch_port_cuda.py."""
import os
import struct
import subprocess
import sys

import pytest
import torch

from medvill_torch.ops import bert_adam as tba
from medvill_torch.train import optim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rows(values, n_tensors):
    rows = [dict(zip(tba.FIELDS, values[i * tba.ROW:(i + 1) * tba.ROW]))
            for i in range(n_tensors)]
    flat = values[n_tensors * tba.ROW:]
    return rows, [tuple(flat[i:i + 2]) for i in range(0, len(flat), 2)]


@pytest.mark.parametrize("chunk,sizes", [
    (8, [40, 37, 1, 0, 8, 17]),
    (tba.CHUNK, [30522 * 768, 30522, 1, 0, 768, 17])], ids=["8", "CHUNK"])
def test_table_cuts_each_tensor_into_chunks(chunk, sizes):
    """Per tensor its row, then its chunks in order: (tensor, start) for
    every ``chunk`` elements, the last ragged; none for an empty tensor."""
    entries = [(4096 * (i + 1), 0 if i == 2 else 8192 * (i + 1),
                16384 * (i + 1), 32768 * (i + 1), n, 64, 0.01 * (i % 2))
               for i, n in enumerate(sizes)]
    values, n_chunks = tba.table_rows(entries, chunk)
    rows, links = _rows(values, len(sizes))
    assert n_chunks == len(links) == sum(-(-n // chunk) for n in sizes)
    want = [(t, c) for t, n in enumerate(sizes) for c in range(0, n, chunk)]
    assert links == want
    for t, (row, e) in enumerate(zip(rows, entries)):
        assert [row[k] for k in ("p", "g", "m", "v", "numel", "lr")] == \
            list(e[:6])
        assert row["count"] == -(-e[4] // chunk)
        assert links[row["first"]:row["first"] + row["count"]] == \
            [(t, c) for c in range(0, e[4], chunk)]
        wd = struct.unpack("<f", struct.pack("<i", row["wd"]))[0]
        assert wd == pytest.approx(e[6], rel=1e-7)
        assert row["wd"] == 0 if e[6] == 0 else row["wd"] != 0
    assert all(-2 ** 63 <= v < 2 ** 63 for v in values)


def test_table_marks_unaligned_tensors():
    """A tensor takes the 16-byte vector path only where p, g, m and v all
    start on 16 bytes (a ZeRO-1 span may not); a missing gradient (address
    0) does not stop it."""
    base = (1 << 20, 1 << 21, 1 << 22, 1 << 23)
    entries = [(*base, 100, 64, 0.0),
               (base[0] + 4, base[1] + 4, *base[2:], 100, 64, 0.0),
               (base[0], 0, *base[2:], 100, 64, 0.0),
               (*base[:3], base[3] + 8, 100, 64, 0.0)]
    rows, _ = _rows(tba.table_rows(entries)[0], len(entries))
    assert [r["aligned"] for r in rows] == [1, 0, 1, 0]


def test_table_refuses_a_chunk_the_kernel_cannot_take():
    for chunk in (0, 6):
        with pytest.raises(ValueError, match="multiple of 4"):
            tba.table_rows([(0, 0, 0, 0, 1, 0, 0.0)], chunk)


def test_table_rebuilds_only_when_an_address_changes():
    table = tba.Table()
    a = [torch.zeros(40000), torch.zeros(3)]
    entries = [(t.data_ptr(), 0, t.data_ptr(), t.data_ptr(), t.numel(),
                a[1].data_ptr(), 0.01) for t in a]
    assert table.update(entries, torch.device("cpu"))
    rows = table.rows
    assert table.n_tensors == 2 and table.n_chunks == 3
    assert table.partials.shape == (3,)
    assert not table.update(list(entries), torch.device("cpu"))
    assert table.rows is rows and table.builds == 1
    moved = [entries[0], (entries[1][0] + 16, *entries[1][1:])]
    assert table.update(moved, torch.device("cpu"))
    assert table.builds == 2 and table.rows is not rows
    assert torch.equal(table.rows, torch.tensor(tba.table_rows(moved)[0]))


def _chain_reference(groups, grads, state, lrs, b1=0.9, b2=0.999, eps=1e-6,
                     max_grad_norm=1.0):
    """BertAdam's update as the foreach chain made it before the kernel:
    ``groups`` of (trained tensors, weight decay), ``grads`` per tensor."""
    params = [p for ps, _ in groups for p in ps]
    gs = [grads[id(p)] if grads[id(p)] is not None else torch.zeros_like(p)
          for p in params]
    norms = torch.stack(torch._foreach_norm(gs))
    clip = torch.clamp(max_grad_norm / (norms + 1e-6), max=1.0)
    gs = torch._foreach_mul(gs, list(clip.unbind(0)))
    i = 0
    for (ps, wd), lr in zip(groups, lrs):
        g, i = gs[i:i + len(ps)], i + len(ps)
        for p in ps:
            state.setdefault(id(p), (torch.zeros_like(p), torch.zeros_like(p)))
        m = [state[id(p)][0] for p in ps]
        v = [state[id(p)][1] for p in ps]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        u = torch._foreach_div(m, torch._foreach_add(torch._foreach_sqrt(v),
                                                     eps))
        if wd > 0:
            torch._foreach_add_(u, ps, alpha=wd)
        torch._foreach_mul_(u, lr)
        torch._foreach_add_(ps, u)


@pytest.mark.parametrize("scale", [3.0, 1e-4], ids=["clipped", "unclipped"])
def test_cpu_parameters_take_the_chain(scale):
    """Three updates through Accumulate (keep_grads) on CPU parameters: no
    kernel launch, no table, the gradients zeroed by Accumulate, and the
    parameters and moments equal, bit for bit, to the chain's: two decay
    groups, a tensor without a gradient, one with requires_grad off."""
    gen = torch.Generator().manual_seed(0)
    shapes = [(64, 32), (30,), (1,), (16, 8), (5, 3)]
    init = [torch.randn(s, generator=gen) for s in shapes]
    steps = [[torch.randn(s, generator=gen) * scale for s in shapes]
             for _ in range(3)]
    params = [torch.nn.Parameter(t.clone()) for t in init]
    params[4].requires_grad_(False)
    opt = optim.BertAdam([{"params": params[:1] + params[3:],
                           "weight_decay": 0.01},
                          {"params": params[1:3], "weight_decay": 0.0}],
                         lr=1e-3, t_total=4, weight_decay=0.01)
    tx = optim.Accumulate(opt, 1)
    tx.keep_grads = True
    ref = [t.clone() for t in init]
    state = {}
    before = tba.bert_adam.launches
    for k, grads in enumerate(steps):
        for i, (p, g) in enumerate(zip(params, grads)):
            if i != 3:
                p.grad = g.clone() if p.grad is None else p.grad.copy_(g)
        assert tx.step()
        lrs = [torch.tensor(-1e-3 * optim.warmup_linear(k / 4, 0.1))] * 2
        _chain_reference([([ref[0], ref[3]], 0.01), (ref[1:3], 0.0)],
                         {id(r): None if i == 3 else g
                          for i, (r, g) in enumerate(zip(ref, grads))},
                         state, lrs)
        for i, p in enumerate(params):
            if p.grad is not None:
                assert not p.grad.any(), i
    assert tba.bert_adam.launches == before and opt._table.builds == 0
    for i, (p, r) in enumerate(zip(params, ref)):
        assert torch.equal(p.detach(), r), i
        if i == 4:
            assert not opt.state[p] and torch.equal(p.detach(), init[4])
            continue
        assert torch.equal(opt.state[p]["m"], state[id(r)][0]), i
        assert torch.equal(opt.state[p]["v"], state[id(r)][1]), i


def test_module_imports_and_cpu_update_run_without_nvcc():
    """No nvcc on PATH nor under /usr/local/cuda: the module imports, a CPU
    update runs, and nothing is built."""
    code = (
        "import shutil, torch\n"
        "from medvill_torch.ops import bert_adam, build\n"
        "from medvill_torch.train import optim\n"
        "assert shutil.which('nvcc') is None\n"
        "def refuse():\n"
        "    raise AssertionError('a build was started')\n"
        "build._nvcc = refuse\n"
        "p = torch.nn.Parameter(torch.ones(5))\n"
        "opt = optim.BertAdam([p], lr=1e-3, t_total=2, warmup=0.0)\n"
        "p.grad = torch.full((5,), 0.5)\n"
        "opt.step()\n"
        "assert bert_adam.bert_adam.launches == 0\n"
        "assert (p.detach() < 1).all()\n"
        "print('OK')\n")
    env = dict(os.environ, PATH=os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc"))))
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr
