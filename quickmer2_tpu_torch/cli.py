"""Command-line interface of the PyTorch/CUDA port, mirroring the JAX
package's (quickmer2_tpu/cli.py):

  python -m quickmer2_tpu_torch search [-k N] [-s SIZE] [-e N] [-d N] [-w N]
                                       [-c ctrl.bed] [--quirk-editdist]
                                       [--emit-devices N] [--json]
                                       [--device cuda|cpu] ref.fa
  python -m quickmer2_tpu_torch count  [--batch-bases N] [--mode flat|anchored]
                                       [--engine mono|packed|sortjoin|linear|auto]
                                       [--checkpoint PATH] [--checkpoint-every N]
                                       [--read-len N] [--data-devices N]
                                       [--dict-devices N] [--json]
                                       [--device cuda|cpu] ref.fa sample out
  python -m quickmer2_tpu_torch cohort [--batch-bases N] [--mode flat|anchored]
                                       [--read-len N] [--data-devices N]
                                       [--dict-devices N] [--json]
                                       [--device cuda|cpu] ref.fa s1.fq:out1 ...
  python -m quickmer2_tpu_torch est    [--plot] [--json] [--device cuda|cpu]
                                       ref.fa sample_prefix out.bed
  python -m quickmer2_tpu_torch sparse [-w N] [-c ctrl.bed] [--device cuda|cpu]
                                       bp ref.fa
  python -m quickmer2_tpu_torch index  [-s SIZE] [--device cuda|cpu]
                                       kmers.bed out.qm
  python -m quickmer2_tpu_torch colortrack --cn cn.bed --name SAMPLE
  python -m quickmer2_tpu_torch colorkey [out.bed]

--device defaults to cuda and the run fails where there is no card;
--device cpu runs the kernels' plain PyTorch versions. The multi-device
options (--emit-devices, --data-devices, --dict-devices) shard over the
box's cards from cuda:0 up (with --device cpu, over copies of the CPU)
and fail when it has too few. --profile is accepted and fails with "not
yet ported".
"""

from __future__ import annotations

import argparse
import json
import sys

from quickmer2_tpu_torch.config import SearchConfig, parse_size_suffix

def _device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the kernels run (default cuda; no fallback)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="quickmer2_tpu_torch",
        description="k-mer copy-number engine, PyTorch/CUDA port")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("search", help="build a unique-k-mer dictionary from a genome")
    s.add_argument("-k", type=int, default=30, help="k-mer size (3-32, default 30)")
    s.add_argument("-t", type=int, default=1, help="threads (CLI parity; unused)")
    s.add_argument("-s", type=str, default="32M", help="hash size (K/M/G suffix ok)")
    s.add_argument("-e", type=int, default=2, help="edit distance 0-2")
    s.add_argument("-d", type=int, default=100, help="edit depth threshold")
    s.add_argument("-w", type=int, default=1000, help="k-mers per window")
    s.add_argument("-c", type=str, default=None, help="control region bed")
    s.add_argument("--quirk-editdist", action="store_true",
                   help="emulate the reference's mod-32 shift in the edit "
                        "filter (k=30; host code)")
    s.add_argument("--out-prefix", type=str, default=None)
    s.add_argument("--json", action="store_true",
                   help="print structured per-phase stats as one JSON line")
    s.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="(not yet ported)")
    s.add_argument("--emit-devices", type=int, default=None,
                   help="run the pass-2 membership scan on N devices "
                        "(k-1 halos; bit-identical artifacts)")
    _device_arg(s)
    s.add_argument("fasta")

    c = sub.add_parser("count", help="count k-mer depth from sample reads")
    c.add_argument("-t", type=int, default=1, help="threads (CLI parity)")
    c.add_argument("--batch-bases", type=int, default=1 << 24)
    c.add_argument("--mode", choices=["flat", "anchored"], default="flat",
                   help="anchored = genome-anchored fast path (needs the "
                        "reference FASTA next to the .qm); bit-identical "
                        "output to flat")
    c.add_argument("--read-len", type=int, default=None,
                   help="fixed read length for anchored mode (autodetected)")
    c.add_argument("--data-devices", type=int, default=None,
                   help="shard the count over N devices (bit-identical "
                        "output)")
    c.add_argument("--dict-devices", type=int, default=None,
                   help="shard the dictionary's packed rows over N "
                        "devices (tables larger than one card; "
                        "bit-identical output)")
    c.add_argument("--checkpoint", type=str, default=None, metavar="PATH",
                   help="periodic resume checkpoint; rerun with the same "
                        "flags to resume (works for stdin too: the "
                        "replayed pipe is fast-forwarded)")
    c.add_argument("--checkpoint-every", type=parse_size_suffix,
                   default=1 << 30, metavar="BYTES",
                   help="checkpoint interval in consumed bytes "
                        "(K/M/G suffix ok, default 1G)")
    c.add_argument("--engine", choices=["mono", "packed", "sortjoin",
                                       "linear", "auto"], default="mono",
                   help="flat-path exact engine; auto picks sortjoin for "
                        "small dictionaries, else mono")
    c.add_argument("--json", action="store_true",
                   help="print the run's structured stats as one JSON "
                        "line on stdout")
    c.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="(not yet ported)")
    _device_arg(c)
    c.add_argument("fasta", help="reference FASTA path or .qm path")
    c.add_argument("sample", help="FASTA/FASTQ reads ('-' for stdin)")
    c.add_argument("out_prefix")

    co = sub.add_parser("cohort", help="count+est many samples against "
                                       "one dictionary (amortized load)")
    co.add_argument("--batch-bases", type=int, default=1 << 24)
    co.add_argument("--mode", choices=["flat", "anchored"], default="flat")
    co.add_argument("--read-len", type=int, default=None)
    co.add_argument("--data-devices", type=int, default=None)
    co.add_argument("--dict-devices", type=int, default=None,
                    help="shard the dictionary rows over N devices "
                         "(bit-identical output)")
    co.add_argument("--json", action="store_true")
    _device_arg(co)
    co.add_argument("fasta", help="reference FASTA path or .qm path")
    co.add_argument("pairs", nargs="+",
                    help="sample.fq:out_prefix pairs (est runs when the "
                         ".qgc companion exists)")

    e = sub.add_parser("est", help="GC-corrected copy-number estimation")
    e.add_argument("--plot", action="store_true", help="write QC png")
    e.add_argument("--json", action="store_true",
                   help="print structured per-phase stats as one JSON line")
    _device_arg(e)
    e.add_argument("fasta", help="reference FASTA path (for .qgc/.bed)")
    e.add_argument("sample_prefix")
    e.add_argument("out_bed")

    sp = sub.add_parser("sparse", help="thin a dictionary / regenerate companions")
    sp.add_argument("-w", type=int, default=1000)
    sp.add_argument("-c", type=str, default=None)
    _device_arg(sp)
    sp.add_argument("bp", type=int)
    sp.add_argument("fasta")

    ix = sub.add_parser("index", help="build a .qm from a k-mer bed list")
    ix.add_argument("-k", type=int, default=30, help="(overridden by row length)")
    ix.add_argument("-s", type=str, default="32M")
    _device_arg(ix)
    ix.add_argument("bed")
    ix.add_argument("out_qm")

    ct = sub.add_parser("colortrack", help="CN bed → UCSC color track")
    ct.add_argument("--cn", required=True)
    ct.add_argument("--name", required=True)

    ck = sub.add_parser("colorkey", help="write the color legend bed")
    ck.add_argument("out", nargs="?", default="color-track.bed")
    return p


def _reject(parser: argparse.ArgumentParser, args, options) -> None:
    """Exit with a clear error for options this slice does not run."""
    for flag, attr, default in options:
        if getattr(args, attr) != default:
            parser.error(f"{args.cmd} {flag} is not yet ported to "
                         f"quickmer2_tpu_torch")


def _qm(fasta: str) -> str:
    return fasta if fasta.endswith(".qm") else fasta + ".qm"


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.cmd == "search":
        _reject(parser, args, [("--profile", "profile", None)])
        from quickmer2_tpu_torch.pipelines.search import run_search
        cfg = SearchConfig(kmer_size=args.k, threads=args.t,
                           hash_size=parse_size_suffix(args.s),
                           edit_distance=args.e, edit_depth_threshold=args.d,
                           window_size=args.w, control_bed=args.c,
                           quirk_mod32_editdist=args.quirk_editdist)
        stats = {}
        run_search(args.fasta, cfg, out_prefix=args.out_prefix,
                   verbose=not args.json, stats=stats, device=args.device,
                   emit_devices=args.emit_devices)
        if args.json:
            print(json.dumps(stats))

    elif args.cmd == "count":
        _reject(parser, args, [("--profile", "profile", None)])
        from quickmer2_tpu_torch.pipelines.count import run_count
        stats = run_count(
            _qm(args.fasta), args.sample, args.out_prefix,
            batch_bases=args.batch_bases, mode=args.mode,
            ref_fasta=args.fasta if args.mode == "anchored" else None,
            read_len=args.read_len, checkpoint_path=args.checkpoint,
            checkpoint_every_bytes=args.checkpoint_every, engine=args.engine,
            data_devices=args.data_devices, dict_devices=args.dict_devices,
            verbose=not args.json, device=args.device)
        if args.json:
            print(json.dumps(stats))

    elif args.cmd == "cohort":
        from quickmer2_tpu_torch.pipelines.cohort import run_cohort
        pairs = []
        for p in args.pairs:
            sample, _, out = p.rpartition(":")
            if not sample:
                parser.error(f"cohort pair {p!r} must be sample:out_prefix")
            pairs.append((sample, out))
        stats = run_cohort(
            _qm(args.fasta), pairs, batch_bases=args.batch_bases,
            mode=args.mode,
            ref_fasta=args.fasta if args.mode == "anchored" else None,
            read_len=args.read_len, verbose=not args.json,
            data_devices=args.data_devices, dict_devices=args.dict_devices,
            device=args.device)
        if args.json:
            print(json.dumps(stats))

    elif args.cmd == "est":
        from quickmer2_tpu_torch.pipelines.est import run_est
        res = run_est(args.fasta, args.sample_prefix, args.out_bed,
                      verbose=not args.json, device=args.device)
        if args.json:
            print(json.dumps({k: v for k, v in res.items()
                              if k != "factors"}))
        if args.plot:
            from quickmer2_tpu_torch.analytics import plots
            if plots.available():
                plots.gc_qc_plot(args.sample_prefix + ".txt", res["factors"])
            else:
                print("matplotlib unavailable; skipping QC plot",
                      file=sys.stderr)

    elif args.cmd == "sparse":
        from quickmer2_tpu_torch.pipelines.sparse import run_sparse
        run_sparse(args.fasta, args.bp, window_size=args.w,
                   control_bed=args.c, device=args.device)

    elif args.cmd == "index":
        from quickmer2_tpu_torch.pipelines.index import run_index
        run_index(args.bed, args.out_qm, hash_size=parse_size_suffix(args.s),
                  device=args.device)

    elif args.cmd == "colortrack":
        from quickmer2_tpu_torch.analytics.colortrack import make_colortrack
        print(f"wrote {make_colortrack(args.cn, args.name)}")

    elif args.cmd == "colorkey":
        from quickmer2_tpu_torch.analytics.colortrack import write_color_key
        print(f"wrote {write_color_key(args.out)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
