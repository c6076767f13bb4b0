"""SvtAv1EncApp-compatible CLI of the port: a copy of
`svt_av1_psy_tpu/app/cli.py` that encodes through the port's `Encoder` and
adds `--device` (default cuda; cpu runs the plain PyTorch versions).

Usage:
  python -m svt_av1_psy_tpu_torch.app.cli -i in.y4m -b out.ivf --crf 35 [--param v]...
  python -m svt_av1_psy_tpu_torch.app.cli -i in.y4m -b out.ivf --device cpu
  python -m svt_av1_psy_tpu_torch.app.cli -i in.y4m --avif 1 -b out.avif
"""

from __future__ import annotations

import sys
import time

from svt_av1_psy_tpu.config import EncoderConfig, parse_parameter
from svt_av1_psy_tpu.errors import SvtAv1Error
from svt_av1_psy_tpu.io.ivf import IVFWriter
from svt_av1_psy_tpu.io.y4m import Y4MReader
from svt_av1_psy_tpu.version import psy_version

from ..api import Encoder


def _usage():
    print(__doc__)
    print("Any reference parameter token works via --<token> <value> "
          "(see svt_av1_psy_tpu.config.parameter_names()); --device cuda|cpu "
          "picks the torch device.")


def _color_help() -> int:
    """--color-help (PSY app layer): the parameter tokens, colorized and
    grouped, like SvtAv1EncApp's color help output."""
    from svt_av1_psy_tpu.config import parameter_names

    use_color = sys.stdout.isatty()

    def c(code, s):
        return f"\033[{code}m{s}\033[0m" if use_color else s

    groups = {
        "rate control": ("rc", "crf", "qp", "tbr", "mbr", "bias-pct",
                         "pass", "stats", "recode", "undershoot",
                         "overshoot", "buf", "gop"),
        "psy": ("psy", "spy", "sharp", "variance", "luminance", "tune",
                "qp-scale", "noise-norm", "max-32", "frame-luma"),
        "filters": ("cdef", "dlf", "restoration", "sgr", "wiener",
                    "superres", "resize"),
        "prediction": ("mv", "ref", "gm", "global", "obmc", "warp",
                       "compound", "interintra", "tf", "hierarchical",
                       "pred", "keyint", "intra", "scd", "scm", "enable-dg"),
    }
    names = sorted(parameter_names())
    seen = set()
    for title, prefixes in groups.items():
        rows = [n for n in names if n not in seen
                and any(p in n for p in prefixes)]
        if not rows:
            continue
        seen.update(rows)
        print(c("1;36", f"[{title}]"))
        for n in rows:
            print("  " + c("33", f"--{n}"))
    rest = [n for n in names if n not in seen]
    if rest:
        print(c("1;36", "[other]"))
        for n in rest:
            print("  " + c("33", f"--{n}"))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or "--help" in argv or "-h" in argv:
        _usage()
        return 0
    if "--version" in argv:
        print(f"svt-av1-psy-tpu-torch {psy_version()}")
        return 0
    if "--color-help" in argv:
        return _color_help()

    in_path = out_path = None
    n_frames = -1
    dv_rpu_path = hdr10p_path = None
    device = "cuda"
    cfg = EncoderConfig()
    i = 0
    try:
        while i < len(argv):
            tok = argv[i]
            if tok in ("-i", "--input"):
                in_path = argv[i + 1]
                i += 2
            elif tok in ("-b", "--output"):
                out_path = argv[i + 1]
                i += 2
            elif tok in ("-n", "--frames"):
                n_frames = int(argv[i + 1])
                i += 2
            elif tok in ("-c", "--config"):
                # config-file parser (app_config.c:1413): one
                # "token : value" or "token value" pair per line,
                # '#' comments
                with open(argv[i + 1]) as cf:
                    for ln in cf:
                        ln = ln.split("#", 1)[0].strip()
                        if not ln:
                            continue
                        if ":" in ln:
                            k, val = ln.split(":", 1)
                        else:
                            parts = ln.split(None, 1)
                            if len(parts) != 2:
                                continue
                            k, val = parts
                        parse_parameter(cfg, k.strip().lstrip("-"),
                                        val.strip())
                i += 2
            elif tok == "--device":
                device = argv[i + 1]
                i += 2
            elif tok == "--dolby-vision-rpu":
                dv_rpu_path = argv[i + 1]
                i += 2
            elif tok == "--hdr10plus-json":
                hdr10p_path = argv[i + 1]
                i += 2
            elif tok.startswith("--"):
                parse_parameter(cfg, tok[2:], argv[i + 1])
                i += 2
            else:
                print(f"unknown argument {tok!r}", file=sys.stderr)
                return 2
    except (IndexError, SvtAv1Error) as e:
        print(f"argument error: {e}", file=sys.stderr)
        return 2
    if not in_path or not out_path:
        print("need -i <in.y4m> and -b <out.ivf|out.avif>", file=sys.stderr)
        return 2

    with open(in_path, "rb") as f:
        reader = Y4MReader(f)
        hdr = reader.header
        cfg.width, cfg.height = hdr.width, hdr.height
        cfg.input_depth = hdr.bit_depth
        cfg.fps_num, cfg.fps_denom = hdr.fps_num, hdr.fps_denom
        if hdr.is_mono:
            cfg.color_format = 0

        enc = Encoder(cfg, device=device).init()
        t0 = time.perf_counter()

        # per-frame HDR dynamic metadata (app_process_cmd.c attach path)
        frame_t35 = {}
        if dv_rpu_path:
            from svt_av1_psy_tpu.codec.metadata import dv_rpu_t35, parse_rpu_file

            with open(dv_rpu_path, "rb") as rf:
                for k, rpu in enumerate(parse_rpu_file(rf.read())):
                    frame_t35.setdefault(k, []).append(dv_rpu_t35(rpu))
        if hdr10p_path:
            import json as _json

            from svt_av1_psy_tpu.codec.metadata import encode_hdr10plus

            with open(hdr10p_path) as jf:
                doc = _json.load(jf)
            scenes = doc.get("SceneInfo", doc if isinstance(doc, list) else [])
            for k, m in enumerate(scenes):
                frame_t35.setdefault(k, []).append(encode_hdr10plus(m))

        if cfg.avif or (out_path.endswith(".avif")):
            cfg.avif = True
            y, u, v = next(reader.frames())
            data = Encoder(cfg, device=device).init().encode_avif(y, u, v)
            with open(out_path, "wb") as out:
                out.write(data)
            print(f"wrote {out_path} ({len(data)} bytes)")
            return 0

        if cfg.pass_num == 1:
            # first pass: stats only, no bitstream
            count = 0
            for y, u, v in reader.frames():
                if 0 <= n_frames <= count:
                    break
                enc.send_picture(y, u, v, pts=count)
                count += 1
            stats_path = cfg.stats_file or (out_path + ".stats")
            with open(stats_path, "wb") as sf:
                sf.write(enc.first_pass_data())
            print(f"pass 1: {count} frames analyzed -> {stats_path}", file=sys.stderr)
            return 0

        with open(out_path, "wb") as out:
            ivf = IVFWriter(out, cfg.width, cfg.height, cfg.fps_num, cfg.fps_denom)
            count = 0
            total = 0
            sent = 0

            def drain():
                nonlocal count, total
                while True:
                    pkt = enc.get_packet()
                    if pkt is None:
                        return
                    ivf.write_frame(pkt.data, pkt.pts)
                    total += len(pkt.data)
                    count += 1
                    if int(cfg.progress) == 3:
                        # PSY progress mode 3: one full line per frame
                        # (frame #, size, running fps/kbps, elapsed)
                        el = time.perf_counter() - t0
                        kbps = (total * 8 * hdr.fps_num
                                / max(count, 1) / hdr.fps_denom / 1000)
                        print(f"frame {count:6d}  {len(pkt.data):7d} B  "
                              f"{count/el:7.2f} fps  {kbps:8.1f} kbps  "
                              f"{el:7.1f}s", file=sys.stderr)
                    elif cfg.progress:
                        el = time.perf_counter() - t0
                        print(f"\rencoded {count} frames  {count/el:.2f} fps  "
                              f"{total*8*hdr.fps_num/max(count,1)/hdr.fps_denom/1000:.0f} kbps",
                              end="", file=sys.stderr)

            for y, u, v in reader.frames():
                if 0 <= n_frames <= sent:
                    break
                for t35 in frame_t35.get(sent, ()):
                    enc.add_metadata(sent, t35)
                enc.send_picture(y, u, v, pts=sent)
                sent += 1
                drain()
            enc.flush()
            drain()
            ivf.finalize()
        el = time.perf_counter() - t0
        print(f"\n{count} frames in {el:.2f}s ({count/max(el,1e-9):.2f} fps) -> {out_path}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
