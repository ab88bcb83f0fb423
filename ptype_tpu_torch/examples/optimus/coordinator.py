"""Optimus coordinator — the port's twin of
``examples/optimus/coordinator.py`` (ref: example/optimus/
coordinator.go:18-99).

HTTP-fronted scatter-gather: ``GET/POST /test?target=N`` splits the
candidate range into ``CHUNK``-wide pieces, fans each to the
prime-worker pool through the balanced client's async ``go``
(round-robin over workers, the reference's one goroutine a chunk), and
the first factor in chunk order wins. The coordinator computes nothing
on a device: it sends ints and reads ints.

Run:  CONFIG=examples/optimus/coordinator.yaml \\
      python -m ptype_tpu_torch.examples.optimus.coordinator
"""

from __future__ import annotations

import math
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from ptype_tpu_torch.cluster import join
from ptype_tpu_torch.config import config_from_env

CHUNK = 1000  # candidates per worker call (ref used width 10 of sleeps)


def split_work(client, target: int) -> int:
    """Fan out Prime.Check chunks; gather the first factor (ref:
    splitWork + watchReplies, coordinator.go:67-99)."""
    hi = int(math.isqrt(target)) + 1
    futures = [
        client.go("Prime.Check", lo, min(lo + CHUNK, hi + 1), target)
        for lo in range(2, hi + 1, CHUNK)
    ]
    result = target
    for fut in futures:
        reply = int(fut.result())
        if reply != target:
            result = reply  # a factor: target is not prime
            break  # chunk order ⇒ smallest factor; first win (ref :91-99)
    return result


class Handler(BaseHTTPRequestHandler):
    client = None  # set in main()

    def do_GET(self):  # noqa: N802 — http.server naming
        url = urlparse(self.path)
        if url.path != "/test":
            self.send_error(404)
            return
        try:
            target = int(parse_qs(url.query)["target"][0])
        except (KeyError, ValueError):
            self.send_error(400, "need ?target=N")
            return
        factor = split_work(self.client, target)
        prime = factor == target
        self.send_response(200)
        self.send_header("Content-Type", "text/plain")
        self.end_headers()
        msg = (f"{target} is prime\n" if prime
               else f"{target} is divisible by {factor}\n")
        self.wfile.write(msg.encode())

    do_POST = do_GET

    def log_message(self, *args):  # quiet
        pass


def main() -> None:
    cfg = config_from_env()
    cluster = join(cfg)
    client = cluster.new_client("prime_worker")
    Handler.client = client

    httpd = ThreadingHTTPServer(("0.0.0.0", cfg.port or 8080), Handler)
    print(f"optimus coordinator on :{httpd.server_port} "
          f"(try /test?target=600851475149)", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        client.close()
        cluster.close()


if __name__ == "__main__":
    main()
