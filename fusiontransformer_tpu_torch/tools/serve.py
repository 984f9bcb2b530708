#!/usr/bin/env python
"""Serve a FusionTransformer model of the port over HTTP (the counterpart of
``tools/serve.py``).

    # The flagship from a checkpoint of the port's trainer, on the card:
    python -m fusiontransformer_tpu_torch.tools.serve \\
        --cfg configs/semantic_kitti/middlefusion.yaml --ckpt model.pth \\
        --port 8433

    # Self-test: random weights, N SyntheticSCN scans of --points rays
    # through the whole HTTP stack from --clients threads, twice (the second
    # pass finds every graph captured), each response held against the
    # engine's serial prediction of the same record; prints one JSON report.
    python -m fusiontransformer_tpu_torch.tools.serve \\
        --cfg configs/semantic_kitti/middlefusion.yaml --selftest 32 \\
        --clients 4 --points 18000 --port 0

Runs on the CUDA card (one CUDA graph per capacity bucket and slot-pool
size, captured at warm-up or on first use) unless ``--device cpu`` is given.
The request is an .npz of ``points`` [N, 3] float32, ``feats`` [N, <=4]
float32, ``img`` HxWx3 float32 or uint8 and ``points_img`` [N, 2] int (row,
col); the response an .npz of ``labels`` [N] (0, the ignore id, for points
outside the camera frustum), ``labels_2d`` (a model with the image stream),
``labels_3d`` (a model with the 3D stream), ``in_frustum`` and
``num_voxels``: the JAX package's schema.  A uni-modal model's ``labels``
are its one stream's, a fusion model's the 2D+3D ensemble's.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="FusionTransformer server "
                                "(PyTorch/CUDA port)")
    p.add_argument("--cfg", required=True, help="config file path")
    p.add_argument("--ckpt", default="", help="checkpoint of the port's "
                   "trainer (empty: random weights, for --selftest)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8433,
                   help="0 picks a free port")
    p.add_argument("--batch", type=int, default=1, help="device batch size")
    p.add_argument("--preproc-workers", type=int, default=2)
    p.add_argument("--no-warmup", action="store_true",
                   help="capture each bucket's graph on its first request "
                   "instead of before serving")
    p.add_argument("--selftest", type=int, default=0, metavar="N",
                   help="send N synthetic scans through the HTTP stack, "
                   "check them, print a report and exit")
    p.add_argument("--clients", type=int, default=1,
                   help="client threads of --selftest")
    p.add_argument("--points", type=int, default=0,
                   help="rays per --selftest scan (default: min(4096, "
                   "TPU.POINT_CAPACITY))")
    p.add_argument("--device", default=None,
                   help="'cpu' to serve the plain PyTorch path; the CUDA "
                   "card otherwise")
    p.add_argument("opts", nargs="*", help="KEY VALUE config overrides")
    return p.parse_args(argv)


def main(argv=None):
    """Serve until interrupted; with ``--selftest`` return its report."""
    args = parse_args(argv)
    from fusiontransformer_tpu_torch.serving import (InferenceEngine,
                                                     InferenceServer)
    from fusiontransformer_tpu_torch.serving.server import HTTPFrontend
    from fusiontransformer_tpu_torch.train import load_cfg

    cfg = load_cfg(args.cfg, args.opts)
    if not args.ckpt:
        print("WARNING: no --ckpt, serving random weights", file=sys.stderr)
    engine = InferenceEngine(cfg, batch_size=args.batch, device=args.device,
                             seed=cfg.RNG_SEED, checkpoint_path=args.ckpt)
    warmup_s = {}
    if not args.no_warmup:
        print("warmup (one captured step per capacity bucket)...",
              file=sys.stderr)
        warmup_s = engine.warmup()
        for b, t in sorted(warmup_s.items()):
            print(f"  bucket {b}: {t:.1f}s", file=sys.stderr)

    server = InferenceServer(engine, preproc_workers=args.preproc_workers)
    frontend = HTTPFrontend(server, host=args.host, port=args.port).start()
    print(f"serving on http://{args.host}:{frontend.port}", file=sys.stderr)
    try:
        if args.selftest:
            report = selftest(cfg, engine, frontend.port, args.selftest,
                              args.clients, args.points)
            report["warmup_s"] = warmup_s
            print(json.dumps(report))
            return report
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        return None
    finally:
        frontend.close()
        server.close()


def selftest_records(cfg, n_scans, n_points=0):
    """``n_scans`` raw request records: SyntheticSCN ray-cast scans of
    ``n_points`` rays (default min(4096, ``TPU.POINT_CAPACITY``)) with
    random images, from fixed seeds."""
    import numpy as np

    from fusiontransformer_tpu_torch.data.synthetic import SyntheticSCN

    ds = dict(cfg.DATASET.get(cfg.DATASET.TYPE, {}))
    h, w = ds.get("image_height", 370), ds.get("image_width", 1226)
    gen = SyntheticSCN(split=("test",), num_scans=n_scans,
                       num_points=n_points or min(4096,
                                                  cfg.TPU.POINT_CAPACITY),
                       image_height=h, image_width=w)
    out = []
    for i in range(n_scans):
        rng = np.random.RandomState(1000 + i)
        points, _, _ = gen._make_scan(rng)
        out.append({
            "points": points,
            "feats": np.concatenate(
                [points, rng.rand(len(points), 1).astype(np.float32)], 1),
            "img": rng.rand(h, w, 3).astype(np.float32),
            "points_img": gen._project(points),
        })
    return out


SELFTEST_PASSES = 2


def selftest(cfg, engine, port, n_scans, clients=1, n_points=0):
    """Post ``n_scans`` records to the server on ``port`` from ``clients``
    threads, ``SELFTEST_PASSES`` times over (a pass after the first finds
    the graphs of every slot-pool size captured); every response must equal
    ``engine.predict`` of the same record run serially afterwards.  Returns
    each pass's latencies (client clock), scans/s and the engine's captures
    during it (the top-level numbers are the first pass's), and the
    server's ``/stats``; raises on a failed request or a mismatch."""
    import urllib.request

    import numpy as np

    from fusiontransformer_tpu_torch.serving.server import (decode_npz,
                                                            encode_record)

    url = f"http://127.0.0.1:{port}"
    recs = selftest_records(cfg, n_scans, n_points)
    bodies = [encode_record(r) for r in recs]
    got = [[None] * n_scans for _ in range(SELFTEST_PASSES)]
    errors, runs = [], []

    def client(c, out, lat):
        for i in range(c, n_scans, clients):
            t0 = time.perf_counter()
            try:
                req = urllib.request.Request(url + "/predict", data=bodies[i],
                                             method="POST")
                with urllib.request.urlopen(req, timeout=600) as resp:
                    out[i] = decode_npz(resp.read())
            except Exception as e:      # noqa: BLE001 - reported below
                errors.append(f"request {i}: {e!r}")
            lat[i] = time.perf_counter() - t0

    for out in got:
        lat = [0.0] * n_scans
        captures = engine.stats()["captures"]
        threads = [threading.Thread(target=client, args=(c, out, lat))
                   for c in range(clients)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        ms = np.asarray(lat) * 1e3
        runs.append({"wall_s": wall, "scans_per_s": n_scans / wall,
                     "client_latency_ms": {
                         "p50": float(np.percentile(ms, 50)),
                         "p99": float(np.percentile(ms, 99)),
                         "mean": float(ms.mean())},
                     "captures": engine.stats()["captures"] - captures})
    if errors:
        raise RuntimeError("; ".join(errors))
    for path in ("/stats", "/healthz"):
        with urllib.request.urlopen(url + path, timeout=60) as resp:
            if resp.status != 200:
                raise RuntimeError(f"GET {path}: {resp.status}")
            body = resp.read()
        if path == "/stats":
            stats = json.loads(body)
        elif body != b"ok":
            raise RuntimeError(f"GET /healthz answered {body!r}")

    for i, rec in enumerate(recs):
        want = engine.predict(rec)
        n = len(rec["points"])
        for out in got:
            if set(out[i]) != set(want):
                raise AssertionError(f"request {i}: keys {sorted(out[i])} "
                                     f"over HTTP, {sorted(want)} serially")
            for key in want:
                if not np.array_equal(out[i][key], want[key]):
                    raise AssertionError(f"request {i}: {key} over HTTP "
                                         f"differs from the serial "
                                         f"prediction")
            lab = out[i]["labels"]
            if lab.shape != (n,) or lab.min() < 0 \
                    or lab.max() >= cfg.MODEL.NUM_CLASSES:
                raise AssertionError(f"request {i}: labels {lab.shape} in "
                                     f"[{lab.min()}, {lab.max()}]")
    return {"selftest_scans_ok": n_scans * SELFTEST_PASSES,
            "clients": clients,
            "points": [len(r["points"]) for r in recs], **runs[0],
            "passes": runs, "matches_serial": True,
            "device": str(engine.device), "stats": stats}


if __name__ == "__main__":
    main()
