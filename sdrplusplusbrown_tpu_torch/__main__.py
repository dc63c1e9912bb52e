"""Headless entry point (counterpart of sdrplusplusbrown_tpu/__main__.py):

    python -m sdrplusplusbrown_tpu_torch --root DIR --http PORT [--autostart]
                                         [--server [--port 5259]]
                                         [--rigctl PORT] [--device cuda|cpu]

reference: core/src/command_args.cpp:4-40 (--root, --http, --server,
--autostart) and server mode core/src/server.cpp:84.  Everything is
driven through the HTTP control plane; ``--server`` adds the IQ streaming
server (``server/stream_server.py``) on ``--port`` and ``--rigctl`` a
hamlib rigctl server (``server/rigctl.py``) on its port.  The app runs on
the card (``--device cuda``, the default) unless ``--device cpu`` asks
for the host; without a CUDA device it exits nonzero.
"""

from __future__ import annotations

import argparse
import gc
import os
import signal
import sys
import threading


def main(argv=None):
    p = argparse.ArgumentParser(prog="sdrplusplusbrown_tpu_torch")
    p.add_argument("--root", default="./sdrpp_tpu_root",
                   help="config root directory")
    p.add_argument("--http", type=int, default=8080,
                   help="HTTP debug/automation server port")
    p.add_argument("--autostart", action="store_true",
                   help="start the DSP immediately")
    p.add_argument("--server", action="store_true",
                   help="run the IQ streaming server (headless TCP)")
    p.add_argument("--port", type=int, default=5259,
                   help="streaming server port (with --server)")
    p.add_argument("--rigctl", type=int, default=0,
                   help="run a hamlib rigctl server on this port")
    p.add_argument("--device", default="cuda",
                   help="torch device of the DSP (default cuda; cpu runs "
                        "the plain versions on the host)")
    args = p.parse_args(argv)

    from .runtime.block import entry_device
    try:
        entry_device(args.device)
    except RuntimeError as e:
        print(f"sdrplusplusbrown_tpu_torch: {e} (--device {args.device}; "
              f"pass --device cpu to run on the host)", file=sys.stderr)
        return 2

    from .app import SDRApp
    from .server.http_server import HttpDebugServer
    from .utils.flog import flog

    done = threading.Event()
    app = SDRApp(args.root, device=args.device)
    http = HttpDebugServer(app, port=args.http, on_exit=done.set)

    stream_server = None
    if args.server:
        from .server.stream_server import StreamServer
        stream_server = StreamServer(app, port=args.port)
        stream_server.start()

    rigctl_server = None
    if args.rigctl:
        from .server.rigctl import RigctlServer
        rigctl_server = RigctlServer(app, port=args.rigctl)
        rigctl_server.start()
    # served last: once /status answers, every listener is up
    http.start()

    if args.autostart:
        app.start()

    def _sig(_s, _f):
        done.set()

    signal.signal(signal.SIGINT, _sig)
    signal.signal(signal.SIGTERM, _sig)
    # the startup heap (torch, the app, its radios) lives as long as the
    # process: out of the collector's way, a full collection walks only
    # what the pump allocates, not ~170 000 import-time objects (~0.1 s
    # of host time a pass, which would land inside a block)
    gc.collect()
    gc.freeze()
    flog.info("ready: http on {}", http.port)
    try:
        done.wait()
    finally:
        if stream_server is not None:
            stream_server.stop()
        if rigctl_server is not None:
            rigctl_server.stop()
        app.shutdown()
        http.stop()
    # skip interpreter teardown: a daemon thread (the pump, an HTTP
    # handler) may still be inside a torch call
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(0)


if __name__ == "__main__":
    sys.exit(main())
