"""Certified-convergence CLI over the audit plane (obs/audit.py).

Three subcommands, mirroring the questions the certification layer
answers::

    # Machine-check merge commutativity/associativity/idempotence and
    # the delta-composition law for every registered op type, batched
    # on-device (--pairs instance pairs per dispatch). Exit 1 on any
    # law failure or any registered type with no fixture.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_audit laws --pairs 512

    # Negative selftest: inject the committed non-commutative fixture
    # (ops/laws.py BrokenMergeDense) and REQUIRE the checker to flag
    # it — exit 0 iff the broken laws fail. A checker that waves the
    # broken merge through is itself broken.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_audit laws --selftest

    # Replay-certify a finished run: flight-log spill + per-worker
    # final digests (JSON file and/or a dir of final-*.json drops) ->
    # signed convergence certificate, or a counterexample slice naming
    # the divergent partitions. Exit 1 when certification fails.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_audit certify /path/to/obs-dir \
        --digests digests.json --reference <hex[-hex...]> --out cert.json

    # Recompute a certificate's sha256 signature over its canonical
    # body. Exit 1 on tamper/corruption.
    python -m antidote_ccrdt_tpu_torch.scripts.ccrdt_audit verify cert.json

Digest inputs accept raw ints, int vectors, or the dashed-hex labels
the certificates themselves print, so a certificate's own
`worker_digests` block round-trips back in.

Port of ``scripts/ccrdt_audit.py`` over the port's ``obs/audit.py``: the
same subcommands, flags, printed text, certificate and exit codes, and two
options of the port's own. ``laws --device`` is the device the law
fixtures build their states on (default: the card; without one it raises,
``--device cpu`` checks on the host). A digest that is a list of lists
(``elastic_demo``'s observable, ``[[id, score], ...]``, in its
``final-*.json``) stands for the crc32 of its canonical JSON, as
``scripts/audit_demo.py`` certifies such fleets; JAX's CLI stops on it
with a TypeError. `certify` and `verify` touch no device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import zlib
from typing import Any, Dict, Optional

if not __package__:  # run as a file: the repository root holds the package
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from antidote_ccrdt_tpu_torch.obs import audit as obs_audit  # noqa: E402


def _parse_digest(v: Any) -> Any:
    """int / [ints] / 'a1b2c3d4' / 'a1b2c3d4-...' -> digest value; a list
    of lists (an observable digest) -> the crc32 of its canonical JSON."""
    if v is None or isinstance(v, int):
        return v
    if isinstance(v, (list, tuple)):
        if any(isinstance(x, (list, tuple)) for x in v):
            return zlib.crc32(json.dumps(v, sort_keys=True).encode("utf-8")) & 0xFFFFFFFF
        return [int(x) for x in v]
    s = str(v).strip()
    if "-" in s:
        return [int(p, 16) for p in s.split("-")]
    try:
        return int(s, 16)
    except ValueError:
        return int(s)


def _load_digests(
    digests_file: Optional[str], final_dir: Optional[str]
) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if final_dir:
        for path in sorted(glob.glob(os.path.join(final_dir, "final-*.json"))):
            try:
                with open(path) as fh:
                    doc = json.load(fh)
            except (OSError, ValueError):
                continue
            member = doc.get("member") or os.path.basename(path)[6:-5]
            if "digest" in doc:
                out[str(member)] = _parse_digest(doc["digest"])
    if digests_file:
        with open(digests_file) as fh:
            doc = json.load(fh)
        for m, d in doc.items():
            out[str(m)] = _parse_digest(d)
    return out


def cmd_laws(args: argparse.Namespace) -> int:
    from antidote_ccrdt_tpu_torch.device import resolve_device

    device = resolve_device(args.device)  # the card unless --device cpu; raises without one
    extra = {}
    if args.selftest:
        from antidote_ccrdt_tpu_torch.ops.laws import broken_merge_fixture

        extra["broken_merge_fixture"] = broken_merge_fixture
        types = ["broken_merge_fixture"]
    else:
        types = (
            [t.strip() for t in args.types.split(",") if t.strip()]
            if args.types else None
        )
    checker = obs_audit.LawChecker(
        types=types, seed=args.seed, pairs=args.pairs, extra_fixtures=extra,
        device=device,
    )
    report = checker.run()
    if args.json:
        print(json.dumps(report, sort_keys=True))
    else:
        for name, rep in sorted(report["types"].items()):
            laws = " ".join(
                f"{law}={'ok' if e['ok'] else 'FAIL'}"
                for law, e in sorted(rep["laws"].items())
            )
            print(
                f"{name:>22} [{rep['merge_kind']:>6}] "
                f"x{rep['n_instances']:<5} {laws}"
            )
        for name in report["unaudited"]:
            print(f"{name:>22} UNAUDITED (no law fixture registered)")
        print(
            f"{report['n_law_checks']} law checks over "
            f"{report['n_types']} types, "
            f"{report['n_law_failures']} failures"
        )
    if args.selftest:
        rep = report["types"].get("broken_merge_fixture", {})
        bad = rep.get("laws", {})
        caught = (
            not bad.get("commutativity", {}).get("ok", True)
            and not bad.get("associativity", {}).get("ok", True)
            and bad.get("idempotence", {}).get("ok", False)
        )
        print(
            "selftest: broken merge "
            + ("CAUGHT (checker is alive)" if caught else "MISSED")
        )
        return 0 if caught else 1
    return 0 if report["ok"] else 1


def cmd_certify(args: argparse.Namespace) -> int:
    digests = _load_digests(args.digests, args.final_dir)
    reference = _parse_digest(args.reference) if args.reference else None
    cert = obs_audit.certify(
        obs_dir=args.obs_dir,
        digests=digests or None,
        reference=reference,
        meta={"obs_dir": os.path.abspath(args.obs_dir)},
    )
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(cert, fh, indent=2, sort_keys=True)
            fh.write("\n")
    if args.json:
        print(json.dumps(cert, sort_keys=True))
    else:
        print(f"certificate  : {'OK' if cert['ok'] else 'FAILED'}")
        for check, ok in sorted(cert["checks"].items()):
            print(f"  {check:<28}: {'ok' if ok else 'FAIL'}")
        print(f"  flight logs : {cert['n_flight_logs']}")
        print(f"  signature   : sha256:{cert['signature']}")
        if not cert["ok"]:
            print("counterexample:")
            print(json.dumps(cert.get("counterexample", {}), indent=2,
                             sort_keys=True))
        if args.out:
            print(f"written      : {args.out}")
    return 0 if cert["ok"] else 1


def cmd_verify(args: argparse.Namespace) -> int:
    with open(args.certificate) as fh:
        cert = json.load(fh)
    ok = obs_audit.verify_certificate(cert)
    kind_ok = cert.get("kind") == obs_audit.CERTIFICATE_KIND
    if args.json:
        print(json.dumps(
            {"signature_valid": ok, "kind_valid": kind_ok,
             "certificate_ok": bool(cert.get("ok"))},
            sort_keys=True,
        ))
    else:
        print(
            f"signature    : {'valid' if ok else 'INVALID (tampered?)'}\n"
            f"kind         : {cert.get('kind')}"
            f"{'' if kind_ok else ' (UNEXPECTED)'}\n"
            f"verdict      : {'OK' if cert.get('ok') else 'FAILED'}"
        )
    return 0 if ok and kind_ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ccrdt_audit", description=__doc__.splitlines()[0]
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("laws", help="lattice-law property check")
    p.add_argument("--types", help="comma-separated type subset")
    p.add_argument("--pairs", type=int, default=512,
                   help="instance pairs per law dispatch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true")
    p.add_argument("--selftest", action="store_true",
                   help="require the committed broken fixture to FAIL")
    p.add_argument("--device", default=None,
                   help="cpu or cuda: the law fixtures' device (default: "
                   "the card; raises without one)")
    p.set_defaults(fn=cmd_laws)

    p = sub.add_parser("certify", help="replay-certify a run's spill")
    p.add_argument("obs_dir")
    p.add_argument("--digests", help="JSON file {member: digest}")
    p.add_argument("--final-dir",
                   help="dir of final-<member>.json drops (elastic_demo)")
    p.add_argument("--reference",
                   help="sequential-reference digest (hex or hex-hex-...)")
    p.add_argument("--out", help="write the signed certificate here")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_certify)

    p = sub.add_parser("verify", help="check a certificate's signature")
    p.add_argument("certificate")
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_verify)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
