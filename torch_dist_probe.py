"""Probe which gloo collectives take CUDA tensors, and what NCCL says to
two ranks on one card.

    python3 torch_dist_probe.py

Needs one CUDA device. Prints the interpreter, torch and CUDA versions,
the card's name and power limit, the outcome of each collective the port
uses (and a few it does not) on CUDA tensors under gloo with two spawned
ranks (the neighbour shift's point-to-point calls and the all-to-all with
split sizes with their values checked), then the error NCCL gives two
ranks on the same device."""
import os, socket, sys, json, subprocess
import torch, torch.distributed as dist
import torch.multiprocessing as mp


def gloo(rank, world, port, q):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world,
                            timeout=__import__("datetime").timedelta(seconds=30))
    d = torch.device("cuda:0")
    res = {}
    def tryop(name, fn):
        try:
            fn(); torch.cuda.synchronize(); res[name] = "ok"
        except Exception as e:
            res[name] = f"FAIL {type(e).__name__}: {str(e)[:160]}"
    x = torch.arange(8, dtype=torch.float32, device=d) + rank
    tryop("all_reduce", lambda: dist.all_reduce(x.clone()))
    tryop("all_reduce_max", lambda: dist.all_reduce(x.clone(), op=dist.ReduceOp.MAX))
    tryop("broadcast", lambda: dist.broadcast(x.clone(), 0))
    tryop("all_to_all_single", lambda: dist.all_to_all_single(torch.empty_like(x), x))
    tryop("all_to_all_single_i8", lambda: dist.all_to_all_single(torch.empty(8, dtype=torch.int8, device=d), torch.ones(8, dtype=torch.int8, device=d)))
    tryop("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(torch.empty(4, device=d), x))
    tryop("reduce_scatter_list", lambda: dist.reduce_scatter(torch.empty(4, device=d), list(x.chunk(2))))
    tryop("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(torch.empty(16, device=d), x))
    tryop("all_gather_list", lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x))
    tryop("all_gather_list_i8", lambda: dist.all_gather([torch.empty(8, dtype=torch.int8, device=d) for _ in range(world)], torch.ones(8, dtype=torch.int8, device=d)))
    tryop("barrier", lambda: dist.barrier())
    res["has_reduce_scatter_single"] = hasattr(dist, "reduce_scatter_single")
    res["has_all_gather_single"] = hasattr(dist, "all_gather_single")
    if rank == 0:
        q.put(res)
    # the neighbour shift (lax.ppermute's counterpart) and the all-to-all
    # with split sizes, values checked; each outcome sent as it comes, in
    # case a point-to-point call on a device pointer takes the process down
    def check(name, fn):
        try:
            got = fn(); torch.cuda.synchronize()
            out = "ok" if got else "WRONG VALUES"
        except Exception as e:
            out = f"FAIL {type(e).__name__}: {str(e)[:160]}"
        if rank == 0:
            q.put({name: out})
        dist.barrier()
    peer = (rank + 1) % world
    def split_a2a():
        src = torch.full((6,), float(rank), device=d)
        out = torch.empty(6, device=d)
        # rank r sends everything to r + 1 and takes everything from r - 1
        ins = [6 if r == peer else 0 for r in range(world)]
        outs = [6 if r == (rank - 1) % world else 0 for r in range(world)]
        dist.all_to_all_single(out, src, output_split_sizes=outs, input_split_sizes=ins)
        return bool((out == float((rank - 1) % world)).all())
    check("all_to_all_single_splits", split_a2a)
    def p2p_cpu():
        src, dst = torch.full((4,), float(rank)), torch.empty(4)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, peer),
                                       dist.P2POp(dist.irecv, dst, (rank - 1) % world)])
        [r.wait() for r in reqs]
        return bool((dst == float((rank - 1) % world)).all())
    check("batch_isend_irecv_cpu", p2p_cpu)
    def p2p_cuda():
        src, dst = torch.full((4,), float(rank), device=d), torch.empty(4, device=d)
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, src, peer),
                                       dist.P2POp(dist.irecv, dst, (rank - 1) % world)])
        [r.wait() for r in reqs]
        return bool((dst == float((rank - 1) % world)).all())
    check("batch_isend_irecv_cuda", p2p_cuda)
    def send_recv_cuda():
        x = torch.full((4,), float(rank), device=d)
        if rank == 0:
            dist.send(x, 1)
            return True
        dist.recv(x, 0)
        return bool((x == 0.0).all())
    check("send_recv_cuda", send_recv_cuda)
    if rank == 0:
        q.put("done")
    dist.destroy_process_group()


def nccl(rank, world, port, q):
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
        x = torch.ones(8, device="cuda:0")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out = f"ok {x[0].item()}"
        dist.destroy_process_group()
    except Exception as e:
        out = f"FAIL {type(e).__name__}: {str(e)[:600]}"
    q.put((rank, out))


def port():
    s = socket.socket(); s.bind(("127.0.0.1", 0)); p = s.getsockname()[1]; s.close(); return p


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True).stdout, flush=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    pp = port()
    procs = [ctx.Process(target=gloo, args=(r, 2, pp, q)) for r in range(2)]
    [p.start() for p in procs]
    print("gloo on cuda:", json.dumps(q.get(timeout=120), indent=1), flush=True)
    while True:
        try:
            item = q.get(timeout=60)
        except Exception as e:
            print("gloo: no answer in 60 s", repr(e), flush=True)
            break
        if item == "done":
            break
        print("gloo on cuda:", json.dumps(item), flush=True)
    [p.join(30) for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    print("gloo ranks' exit codes:", [p.exitcode for p in procs], flush=True)
    pp = port()
    procs = [ctx.Process(target=nccl, args=(r, 2, pp, q)) for r in range(2)]
    [p.start() for p in procs]
    for _ in range(2):
        try:
            print("nccl two ranks one card:", q.get(timeout=90), flush=True)
        except Exception as e:
            print("nccl: no answer in 90 s", repr(e), flush=True)
    for p in procs:
        p.join(10)
        if p.is_alive():
            p.kill()
    import importlib.util
    print("cloudpickle:", importlib.util.find_spec("cloudpickle") is not None)
