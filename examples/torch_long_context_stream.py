"""Long-context decode with streaming FLARE on the PyTorch port: the state
a layer carries, and so the cost of each decoded token, stay constant as
the context grows (the mechanism behind the long_500k cell). The port's
counterpart of ``examples/long_context_stream.py``.

    PYTHONPATH=src python examples/torch_long_context_stream.py
    PYTHONPATH=src python examples/torch_long_context_stream.py --device cpu --smoke

It runs on ``cuda`` unless ``--device cpu`` is given, and raises where there
is no CUDA device.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core.flare_stream import stream_append, stream_chunk, stream_init

H, M, D, B = 4, 32, 16, 1


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--chunk", type=int, default=16384, help="tokens a prefill chunk")
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--decode-steps", type=int, default=50)
    ap.add_argument("--smoke", action="store_true", help="2 chunks of 512 tokens, 5 decodes")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    dev = torch.device(args.device)
    chunk, chunks, decode_steps = ((512, 2, 5) if args.smoke
                                   else (args.chunk, args.chunks, args.decode_steps))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    gen = torch.Generator().manual_seed(0)
    randn = lambda *shape, s=1.0: (torch.randn(*shape, generator=gen) * s).to(dev)
    q = randn(H, M, D, s=0.3)
    state = stream_init(B, H, M, D, device=dev)
    state_bytes = sum(x.numel() * x.element_size() for x in state)
    print(f"FLARE streaming state: {state_bytes / 1024:.1f} KiB (M={M} latents x D={D} a "
          f"head x {H} heads), where a KV cache grows linearly with the context")

    # prefill in chunks: the time a chunk stays flat as the context grows
    ctx, chunk_ms = 0, []
    for _ in range(chunks):
        kc, vc = randn(B, H, chunk, D, s=0.3), randn(B, H, chunk, D)
        sync()
        t0 = time.perf_counter()
        state, _ = stream_chunk(state, q, kc, vc)
        sync()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        ctx += chunk
        print(f"  prefilled to {ctx:6d} tokens  ({chunk_ms[-1]:7.1f} ms a {chunk}-token chunk)")

    # decode: the time a token does not depend on the context
    times = []
    for _ in range(decode_steps):
        kt, vt = randn(B, H, D, s=0.3), randn(B, H, D)
        sync()
        t0 = time.perf_counter()
        state, y = stream_append(state, q, kt, vt)
        sync()
        times.append(time.perf_counter() - t0)
    us = float(np.median(times) * 1e6)
    print(f"decode at {ctx}-token context: {us:.0f} us/token (state still "
          f"{state_bytes / 1024:.1f} KiB)")
    print("=> O(M*D) a token and O(1) memory in the context length.")
    return {"state_bytes": state_bytes, "context": ctx, "chunk_ms": chunk_ms,
            "decode_us": us, "finite": bool(torch.isfinite(y).all())}


if __name__ == "__main__":
    main()
