"""The certified-convergence plane: lattice-law auditing, flight-log
replay certification, and a live divergence watchdog.

Three verdict surfaces over the same machinery the fleet already runs:

* **LawChecker** — machine-checks merge commutativity/associativity/
  idempotence and the delta-composition law for every op type on the
  registry (batched on-device; kernels + reachable-state fixtures live
  in `ops/laws.py`). A type without a registered fixture is reported as
  unaudited, never silently skipped.

* **certify / verify_certificate** — replay certification of a real
  run: consume the ``(origin, dseq)`` flight-recorder spill
  (`obs.events.scan_dir`), audit causal delivery per process
  incarnation, reconcile published-vs-covered op counts per
  (applier, origin) pair, compare per-worker partition-digest vectors
  (`obs.lag.digest_agreement`) and optionally a sequential reference —
  then emit a signed-digest *convergence certificate* (sha256 over the
  canonical JSON body), or a minimal counterexample slice naming the
  divergent partitions when certification fails.

* **DivergenceWatchdog** — rides the per-partition digest vectors the
  partial anti-entropy tier already exchanges (`PartialAntiEntropy`
  feeds `observe_peer` on every digest fetch): per-peer divergence
  state machine (ok → diverged → wedged), time-to-agreement samples,
  and a wedged-divergence alarm when digests disagree AND no repair
  progress lands within the bound. Gauges/counters ride the ordinary
  `utils.metrics.Metrics` object, so all three scrape surfaces (HTTP,
  in-band frame, bridge op) export them for free; `health_fields()`
  extends ``/healthz`` via the never-fatal `health_extra` probe.

Module discipline: top-level imports are stdlib + the stdlib-only obs
siblings, so `scripts/ccrdt_trace.py` (and any cold CLI) can import the
causal auditor without paying for torch; `LawChecker.run` pulls
`ops.laws` lazily.

Port of ``antidote_ccrdt_tpu/obs/audit.py``: certificates are byte-equal
to the JAX package's (the same canonical JSON and sha256), so each
package verifies the other's. `LawChecker(device=)` picks the device the
port's law fixtures build their states on (the CUDA card by default).
"""

from __future__ import annotations

import hashlib
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import events as obs_events
from .lag import digest_agreement

CERTIFICATE_KIND = "ccrdt-convergence-certificate"
CERTIFICATE_VERSION = 1


# -- causal apply-order audit ------------------------------------------------
# Canonical home of the auditor scripts/ccrdt_trace.py `audit` exposes
# (the CLI imports it from here); kept stdlib-only on purpose.


def audit_apply_order(
    logs: Dict[str, List[Dict[str, Any]]]
) -> List[Dict[str, Any]]:
    """Causal-order violations in the apply streams, one row each.

    Within ONE flight log (= one process incarnation) the `delta.apply`
    events for a given origin must carry contiguous ascending dseqs:
    `sweep_deltas` only emits the event after advancing its cursor by
    exactly one; a `snap.apply` at step S or a partial resync
    (`psnap.resync` at dig_seq S) are the only legitimate jumps (the
    cursor resumes from max(cur, S)). The baseline is the
    FIRST dseq seen in the log, not 0 — the ring truncates and a worker
    may join mid-stream, so absolute position proves nothing; ordering
    within the log does. Events replay in the recorder's own `seq`
    order (per-process lamport axis), so wall-clock skew cannot
    manufacture violations. A `gap-skip` (dseq jumped past cur+1 with no
    snapshot) means ops were silently lost; a `double-apply` (dseq at or
    below the cursor) means the cursor went backwards. Different
    incarnations of the same member audit independently: recovery
    legitimately re-applies."""
    violations: List[Dict[str, Any]] = []
    for fname, evs in sorted(logs.items()):
        applier = next(
            (str(e["member"]) for e in evs if e.get("member")), fname
        )
        ordered = sorted(
            (
                e for e in evs
                if e.get("kind") in ("delta.apply", "snap.apply",
                                     "psnap.resync")
                and e.get("origin") is not None
            ),
            key=lambda e: int(e.get("seq", 0)),
        )
        cur: Dict[str, int] = {}
        for ev in ordered:
            origin = str(ev["origin"])
            if ev["kind"] in ("snap.apply", "psnap.resync"):
                s = ev.get("step") if ev["kind"] == "snap.apply" \
                    else ev.get("dig_seq")
                if s is not None:
                    prev = cur.get(origin)
                    cur[origin] = int(s) if prev is None else max(prev, int(s))
                continue
            d = ev.get("dseq")
            if d is None:
                continue
            d = int(d)
            # Compacted range frames apply as one event covering
            # [lo..dseq]; chaining holds iff the frame's LOW edge meets
            # the cursor (overlap below it is idempotent re-coverage,
            # not a violation). Legacy events carry no lo: lo == dseq.
            lo = int(ev.get("lo", d))
            prev = cur.get(origin)
            if prev is None or (lo <= prev + 1 and d > prev):
                cur[origin] = d
                continue
            violations.append(
                {
                    "log": fname,
                    "applier": applier,
                    "origin": origin,
                    "kind": "double-apply" if d <= prev else "gap-skip",
                    "prev_dseq": prev,
                    "dseq": d,
                    "seq": int(ev.get("seq", -1)),
                }
            )
            cur[origin] = max(prev, d)
    return violations


# -- op-count reconciliation -------------------------------------------------


def reconcile_op_counts(
    logs: Dict[str, List[Dict[str, Any]]]
) -> Dict[str, Any]:
    """Published-vs-covered reconciliation over a QUIESCED run's spill.

    For every origin with `delta.publish` events, each OTHER member's
    final coverage — the max of its applied dseqs, `snap.apply` steps,
    and partial-resync digest seqs (all on the publisher's one seq axis)
    — must reach the origin's highest published dseq. A member below
    that watermark at end of run has silently lost ops (the causal audit
    catches mis-ordering; this catches truncation). Members are judged
    on the union of their incarnations, so a recovered worker's
    coverage carries across its restart.

    A member DEAD at quiesce — its last incarnation is a crash dump (no
    `proc.exit`, see obs/events.py) with no successor — is excluded
    from the applier side and reported in `dead_members`: its final
    state never existed, so "covered through" is not defined for it.
    Its PUBLISHED stream stays fully audited — the survivors must still
    cover everything it shipped before dying (replica adoption), which
    is exactly the loss this check hunts. The exclusion activates only
    when some log carries the proc lifecycle discipline (a `proc.exit`
    somewhere); in-process sim spills without lifecycle events keep
    every member on the hook."""
    published: Dict[str, List[int]] = {}
    for evs in logs.values():
        for e in evs:
            if e.get("kind") == "delta.publish" and e.get("dseq") is not None:
                o = str(e.get("origin") or e.get("member") or "?")
                published.setdefault(o, []).append(int(e["dseq"]))

    lifecycle = any(
        e.get("kind") == "proc.exit" for evs in logs.values() for e in evs
    )
    incarnations: Dict[str, List[Tuple[float, bool]]] = {}
    for fname, evs in sorted(logs.items()):
        member = next(
            (str(e["member"]) for e in evs if e.get("member")), fname
        )
        start_t = next(
            (
                float(e.get("t", 0.0))
                for e in evs
                if e.get("kind") == "proc.start"
            ),
            min((float(e.get("t", 0.0)) for e in evs), default=0.0),
        )
        exited = any(e.get("kind") == "proc.exit" for e in evs)
        incarnations.setdefault(member, []).append((start_t, exited))
    dead = {
        m for m, incs in incarnations.items()
        if lifecycle and not sorted(incs)[-1][1]
    }

    coverage: Dict[str, Dict[str, int]] = {}
    applied_n: Dict[str, Dict[str, int]] = {}
    for fname, evs in sorted(logs.items()):
        member = next(
            (str(e["member"]) for e in evs if e.get("member")), fname
        )
        cov = coverage.setdefault(member, {})
        nap = applied_n.setdefault(member, {})
        for e in sorted(evs, key=lambda e: int(e.get("seq", 0))):
            kind, origin = e.get("kind"), e.get("origin")
            if origin is None:
                continue
            o = str(origin)
            if kind == "delta.apply" and e.get("dseq") is not None:
                cov[o] = max(cov.get(o, -1), int(e["dseq"]))
                nap[o] = nap.get(o, 0) + 1
            elif kind == "snap.apply" and e.get("step") is not None:
                cov[o] = max(cov.get(o, -1), int(e["step"]))
            elif kind == "psnap.resync" and e.get("dig_seq") is not None:
                cov[o] = max(cov.get(o, -1), int(e["dig_seq"]))

    uncovered: List[Dict[str, Any]] = []
    pairs = 0
    for origin, seqs in sorted(published.items()):
        want = max(seqs)
        for member, cov in sorted(coverage.items()):
            if member == origin or member in dead:
                continue
            pairs += 1
            have = cov.get(origin, -1)
            if have < want:
                uncovered.append(
                    {
                        "applier": member,
                        "origin": origin,
                        "covered_through": have,
                        "published_through": want,
                        "applied": applied_n.get(member, {}).get(origin, 0),
                    }
                )
    return {
        "ok": not uncovered,
        "origins": {
            o: {"published": len(s), "max_dseq": max(s)}
            for o, s in sorted(published.items())
        },
        "pairs_checked": pairs,
        "dead_members": sorted(dead),
        "uncovered": uncovered,
    }


# -- durability-watermark reconciliation -------------------------------------


def reconcile_durability(
    logs: Dict[str, List[Dict[str, Any]]]
) -> Dict[str, Any]:
    """Published-vs-durable reconciliation on the `wal.*` flight-event
    axis (async durability: gossip may ship a delta BEFORE its
    fsync, so a crash can lose appended-but-unacked records — legal
    ONLY if the loss is visible here and covered by a successor).

    Per crashed incarnation (a flight log with no `proc.exit`): its
    exposure is S = max `wal.append` wseq — everything it might have
    published — against W = its last `wal.durable` watermark. S > W
    means the crash could have dropped (W, S]. That exposure is COVERED
    iff a later incarnation of the same member (ordered by `proc.start`
    time) re-derives the range: its own `wal.append` trail reaches S
    (it resumed at W+1 and re-ran the steps) or its `wal.recover`
    found last_step >= S (the tail survived — group-mode under-claims).
    Anything else is unaudited loss and fails the certificate with a
    counterexample naming the uncovered seq range.

    The check activates only when some log carries `wal.durable`
    events (group/async modes emit them per flush; a sync-mode or
    WAL-less run has no watermark discipline to audit)."""
    incs: List[Any] = []
    for fname, evs in sorted(logs.items()):
        member = next(
            (str(e["member"]) for e in evs if e.get("member")), fname
        )
        start_t = next(
            (
                float(e.get("t", 0.0))
                for e in evs
                if e.get("kind") == "proc.start"
            ),
            min((float(e.get("t", 0.0)) for e in evs), default=0.0),
        )
        incs.append((member, start_t, fname, evs))
    active = any(
        e.get("kind") == "wal.durable" for _, _, _, evs in incs for e in evs
    )
    exposed: List[Dict[str, Any]] = []
    covered = 0
    checked = 0
    for member, t0, fname, evs in incs:
        if any(e.get("kind") == "proc.exit" for e in evs):
            continue  # clean exit: close() flushed, nothing exposed
        appends = [
            int(e["wseq"])
            for e in evs
            if e.get("kind") == "wal.append" and e.get("wseq") is not None
        ]
        if not appends:
            continue
        checked += 1
        s_hi = max(appends)
        w = max(
            (
                int(e["through"])
                for e in evs
                if e.get("kind") == "wal.durable"
                and e.get("through") is not None
            ),
            default=-1,
        )
        if s_hi <= w:
            continue  # everything appended was acked durable
        ok = False
        for m2, t2, f2, evs2 in incs:
            if m2 != member or f2 == fname or t2 <= t0:
                continue
            a2 = max(
                (
                    int(e["wseq"])
                    for e in evs2
                    if e.get("kind") == "wal.append"
                    and e.get("wseq") is not None
                ),
                default=-1,
            )
            r2 = max(
                (
                    int(e.get("last_step", -1))
                    for e in evs2
                    if e.get("kind") == "wal.recover"
                ),
                default=-1,
            )
            if a2 >= s_hi or r2 >= s_hi:
                ok = True
                break
        if ok:
            covered += 1
        else:
            exposed.append(
                {
                    "member": member,
                    "durable_through": w,
                    "exposed_through": s_hi,
                    "uncovered": [w + 1, s_hi],
                }
            )
    return {
        "ok": not exposed,
        "active": active,
        "crashed_checked": checked,
        "covered": covered,
        "exposed": exposed,
    }


# -- convergence certificates ------------------------------------------------


def _digest_key(d: Any) -> Any:
    if d is None:
        return None
    if isinstance(d, (list, tuple)) or hasattr(d, "__len__"):
        return tuple(int(x) for x in d)
    return int(d)


def _digest_label(d: Any) -> Optional[str]:
    k = _digest_key(d)
    if k is None:
        return None
    if isinstance(k, tuple):
        return "-".join("%08x" % e for e in k)
    return "%08x" % k


def _canonical(body: Dict[str, Any]) -> bytes:
    return json.dumps(
        body, sort_keys=True, separators=(",", ":"), default=str
    ).encode()


def sign_certificate(doc: Dict[str, Any]) -> Dict[str, Any]:
    """Stamp `signature` = sha256 over the canonical JSON of everything
    else. Not cryptographic authentication (no key) — a tamper-evident
    content digest, the same trust model as the repo's crc32 state
    digests but collision-resistant enough to archive."""
    body = {k: v for k, v in doc.items() if k != "signature"}
    doc["signature"] = hashlib.sha256(_canonical(body)).hexdigest()
    return doc


def verify_certificate(doc: Dict[str, Any]) -> bool:
    sig = doc.get("signature")
    if not isinstance(sig, str):
        return False
    body = {k: v for k, v in doc.items() if k != "signature"}
    return hashlib.sha256(_canonical(body)).hexdigest() == sig


def _counterexample(
    causal: List[Dict[str, Any]],
    recon: Dict[str, Any],
    agreement: Optional[Dict[str, Any]],
    reference: Optional[Dict[str, Any]],
    durability: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The minimal slice an operator needs to localize the failure:
    WHICH partitions split, WHICH member groups hold which digest, the
    first causal violations, the first uncovered (applier, origin)
    ranges, the first pre-fsync-loss exposures with their seq ranges."""
    out: Dict[str, Any] = {}
    if agreement is not None and not agreement.get("agree", True):
        out["divergent_parts"] = agreement.get("divergent_parts", [])
        out["digest_groups"] = agreement.get("groups", {})
    if reference is not None and not reference.get("ok", True):
        out["reference_mismatch"] = reference.get("mismatched", {})
    if causal:
        out["causal_violations"] = causal[:5]
    if recon.get("uncovered"):
        out["uncovered"] = recon["uncovered"][:5]
    if durability is not None and durability.get("exposed"):
        out["durability_exposures"] = durability["exposed"][:5]
    return out


def certify(
    obs_dir: Optional[str] = None,
    logs: Optional[Dict[str, List[Dict[str, Any]]]] = None,
    digests: Optional[Dict[str, Any]] = None,
    reference: Any = None,
    meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Replay-certify a finished run into a signed convergence
    certificate.

    Inputs: the flight-log spill (`obs_dir` or a pre-scanned `logs`
    dict), per-worker final digests (scalar or per-partition vectors),
    and optionally the sequential-reference digest the fleet must match.
    The certificate's `ok` is the conjunction of every check it could
    run; a check with no evidence (no digests, no reference) is absent,
    not vacuously true. On failure the doc gains a `counterexample`
    slice naming the divergent partitions / members / seq ranges."""
    if logs is None:
        logs = obs_events.scan_dir(obs_dir) if obs_dir else {}
    causal = audit_apply_order(logs)
    recon = reconcile_op_counts(logs)
    durability = reconcile_durability(logs)
    agreement = digest_agreement(digests) if digests else None
    reference_section: Optional[Dict[str, Any]] = None
    if reference is not None and digests:
        ref_key = _digest_key(reference)
        mismatched = {
            m: _digest_label(d)
            for m, d in sorted(digests.items())
            if _digest_key(d) != ref_key
        }
        reference_section = {
            "ok": not mismatched,
            "reference": _digest_label(reference),
            "mismatched": mismatched,
        }

    checks: Dict[str, bool] = {
        "causal_delivery": not causal,
        "op_count_reconciliation": bool(recon["ok"]),
    }
    if agreement is not None:
        checks["partition_digest_agreement"] = bool(agreement["agree"])
    if reference_section is not None:
        checks["matches_reference"] = bool(reference_section["ok"])
    if durability["active"]:
        # Only when some log carries a durability watermark: a run
        # without group/async WAL has no published-vs-durable gap to
        # audit, and an absent check must stay absent, not vacuously
        # true.
        checks["durability_watermark"] = bool(durability["ok"])
    ok = all(checks.values())

    doc: Dict[str, Any] = {
        "kind": CERTIFICATE_KIND,
        "version": CERTIFICATE_VERSION,
        "t": round(time.time(), 3),
        "ok": ok,
        "checks": checks,
        "worker_digests": (
            {m: _digest_label(d) for m, d in sorted(digests.items())}
            if digests else {}
        ),
        "causal": {
            "ok": not causal,
            "n_violations": len(causal),
            "violations": causal[:16],
        },
        "reconciliation": recon,
        "durability": durability,
        "agreement": agreement,
        "reference": reference_section,
        "n_flight_logs": len(logs),
        "meta": meta or {},
    }
    if not ok:
        doc["counterexample"] = _counterexample(
            causal, recon, agreement, reference_section, durability
        )
    sign_certificate(doc)
    obs_events.emit(
        "audit.certificate", ok=ok,
        signature=doc["signature"][:16],
        divergent_parts=(
            doc.get("counterexample", {}).get("divergent_parts", [])
        ),
    )
    return doc


# -- session-guarantee certification -----------------------------------------


SESSION_CERTIFICATE_KIND = "ccrdt-session-certificate"
SESSION_CERTIFICATE_VERSION = 1


def certify_sessions(
    obs_dir: Optional[str] = None,
    logs: Optional[Dict[str, List[Dict[str, Any]]]] = None,
    meta: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """Replay the flight log's ``session.write`` / ``session.read``
    events and certify the read tier's two session guarantees — the
    replication-aware-spec replay idea of arxiv 2502.19967 applied to
    the session taxonomy of arxiv 2310.18220:

    * **read-your-writes**: every read in a session must be served with
      watermarks covering every (origin, wseq) the session wrote
      BEFORE it — replayed as a running per-origin write floor;
    * **monotonic-reads**: every read must cover the pointwise max of
      the watermarks every earlier read in the session observed.

    The floors are recomputed here independently from the raw events —
    the router's in-flight `require` stamps are NOT trusted (a router
    in ``session_mode="ignore"``, the deliberately-violating arm, still
    records truthful writes/reads, and this replay is what convicts it).
    Events are ordered per session by (log file, recorder seq): a
    session lives in one process, so the process-local recorder order
    IS its program order.

    Returns a signed certificate (`sign_certificate`); on violation,
    `ok` is False and `counterexample` names the minimal first offense
    per guarantee: session, peer, origin, and the [have, want] seq
    range."""
    if logs is None:
        logs = obs_events.scan_dir(obs_dir) if obs_dir else {}
    # Gather each session's events in replay order.
    per_session: Dict[str, List[Tuple[str, int, Dict[str, Any]]]] = {}
    for fname in sorted(logs):
        for ev in logs[fname]:
            k = ev.get("kind")
            if k not in ("session.write", "session.read"):
                continue
            sid = str(ev.get("session"))
            per_session.setdefault(sid, []).append(
                (fname, int(ev.get("seq", 0)), ev)
            )
    violations: List[Dict[str, Any]] = []
    n_reads = n_writes = 0
    for sid in sorted(per_session):
        evs = sorted(per_session[sid], key=lambda x: (x[0], x[1]))
        wfloor: Dict[str, int] = {}  # writes this session has seen land
        rfloor: Dict[str, int] = {}  # watermarks earlier reads observed
        for _f, _s, ev in evs:
            if ev["kind"] == "session.write":
                n_writes += 1
                o = str(ev.get("origin"))
                w = int(ev.get("wseq", -1))
                if w > wfloor.get(o, -1):
                    wfloor[o] = w
                continue
            n_reads += 1
            served = {
                str(o): int(s)
                for o, s in (ev.get("served") or {}).items()
            }
            checks = []
            if ev.get("rw", True):
                checks.append(("read_your_writes", wfloor))
            if ev.get("mono", True):
                checks.append(("monotonic_reads", rfloor))
            for guarantee, floor in checks:
                for o, want in floor.items():
                    have = int(served.get(o, -1))
                    if have < want:
                        violations.append({
                            "guarantee": guarantee,
                            "session": sid,
                            "peer": str(ev.get("peer")),
                            "origin": o,
                            "have": have,
                            "want": want,
                        })
            if ev.get("mono", True):
                for o, s in served.items():
                    if s > rfloor.get(o, -1):
                        rfloor[o] = s
    by_guarantee = {
        g: [v for v in violations if v["guarantee"] == g]
        for g in ("read_your_writes", "monotonic_reads")
    }
    checks = {g: not vs for g, vs in by_guarantee.items()}
    ok = all(checks.values())
    doc: Dict[str, Any] = {
        "kind": SESSION_CERTIFICATE_KIND,
        "version": SESSION_CERTIFICATE_VERSION,
        "t": round(time.time(), 3),
        "ok": ok,
        "checks": checks,
        "n_sessions": len(per_session),
        "n_reads": n_reads,
        "n_writes": n_writes,
        "n_violations": len(violations),
        "n_flight_logs": len(logs),
        "meta": meta or {},
    }
    if not ok:
        # The minimal counterexample: the FIRST violation per guarantee
        # (replay order), enough to name the offending token scope.
        doc["counterexample"] = {
            g: vs[0] for g, vs in by_guarantee.items() if vs
        }
        doc["violations"] = violations[:16]
    sign_certificate(doc)
    obs_events.emit(
        "audit.session_certificate", ok=ok,
        n_violations=len(violations),
        signature=doc["signature"][:16],
    )
    return doc


# -- write-ack durability certification --------------------------------------


WRITE_CERTIFICATE_KIND = "ccrdt-write-durability-certificate"
WRITE_CERTIFICATE_VERSION = 1


def certify_writes(
    obs_dir: Optional[str] = None,
    logs: Optional[Dict[str, List[Dict[str, Any]]]] = None,
    meta: Optional[Dict[str, Any]] = None,
    strict_exactly_once: bool = False,
) -> Dict[str, Any]:
    """Replay the flight log's ``ingest.ack`` events (what the write
    tier TOLD clients they hold) against the fleet's durability and
    replication evidence, and certify **zero acked-but-lost writes** —
    the write-path twin of `certify_sessions`, and the check the
    acceptance drill SIGKILLs a partition owner against.

    An ack at level ``durable`` or ``replicated_to_k`` for ``(origin,
    wseq)`` is a contract: the write must survive the origin's death.
    Coverage is recomputed here from raw events — the acking plane is
    NOT trusted (the deliberately-violating ack-before-fsync arm still
    records truthful ``wal.durable`` watermarks, and this replay is
    what convicts it). ``(origin, s)`` is covered iff any of:

    * every incarnation of `origin` exited cleanly (``proc.exit``:
      close() flushed, nothing was lost);
    * some incarnation of `origin` fsynced through s (``wal.durable``
      through >= s — the honest plane never acks ``durable`` before
      this watermark passes);
    * a restarted `origin` recovered its WAL tail through s
      (``wal.recover`` last_step >= s: the record survived on disk —
      `harness.wal.log_step` serialized the post-fold view, so the
      client write is inside it);
    * a SURVIVOR holds it: another member applied origin's delta/snap
      stream through s (``delta.apply`` dseq / ``snap.apply`` step /
      ``psnap.resync`` dig_seq for that origin) — the state outlives
      the owner in the fleet even if the owner's disk burned.

    Note what does NOT count: a later incarnation's own re-run
    ``wal.append`` trail (valid for the step-replay audit in
    `reconcile_durability`, but a re-run regenerates DRILL load, not
    client writes). ``applied``-level acks promise nothing across a
    crash and are reported but never convicted.

    The certificate also audits DUPLICATION, the converse of loss: the
    planes emit one ``ingest.fold`` event per folded write_id, so a
    write_id folded more than once — the at-least-once owner-failover
    case, where the first owner applied the batch but its ack was lost
    and the successor applied it again — lands in the ``duplicates``
    section with the folding (member, wseq) sites. By default this is
    reported, not convicted (the registered CRDT types absorb duplicate
    folds under their stamped join); pass ``strict_exactly_once=True``
    to make any duplicate application fail certification — the right
    setting when the op stream is not duplicate-tolerant.

    Returns a signed certificate; on failure `ok` is False and
    `counterexample` names the lost seq range per origin plus the
    acked write_ids inside it (and, under strict mode, the duplicated
    write_ids with their fold sites)."""
    if logs is None:
        logs = obs_events.scan_dir(obs_dir) if obs_dir else {}
    # -- the promises: client-side acks, grouped by origin ------------
    acks: Dict[str, List[Tuple[int, str, str]]] = {}
    n_acks = 0
    by_level: Dict[str, int] = {}
    for fname in sorted(logs):
        for ev in logs[fname]:
            if ev.get("kind") != "ingest.ack":
                continue
            n_acks += 1
            lvl = str(ev.get("level", ""))
            by_level[lvl] = by_level.get(lvl, 0) + 1
            o = str(ev.get("origin"))
            s = int(ev.get("wseq", -1))
            if s >= 0:
                acks.setdefault(o, []).append(
                    (s, lvl, str(ev.get("write_id", "")))
                )
    # -- the evidence: per-origin coverage floors ---------------------
    exposures: List[Dict[str, Any]] = []
    per_origin: Dict[str, Dict[str, Any]] = {}
    for origin in sorted(acks):
        hard = [
            (s, lvl, wid) for s, lvl, wid in acks[origin]
            if lvl in ("durable", "replicated_to_k")
        ]
        own_logs = [
            evs for evs in logs.values()
            if any(str(e.get("member")) == origin for e in evs
                   if e.get("member"))
        ]
        clean = bool(own_logs) and all(
            any(e.get("kind") == "proc.exit" for e in evs)
            for evs in own_logs
        )
        durable_floor = max(
            (
                int(e["through"])
                for evs in own_logs for e in evs
                if e.get("kind") == "wal.durable"
                and e.get("through") is not None
            ),
            default=-1,
        )
        recover_floor = max(
            (
                int(e.get("last_step", -1))
                for evs in own_logs for e in evs
                if e.get("kind") == "wal.recover"
            ),
            default=-1,
        )
        survivor_floor = -1
        for fname, evs in logs.items():
            applier = next(
                (str(e["member"]) for e in evs if e.get("member")), fname
            )
            if applier == origin:
                continue
            for e in evs:
                k = e.get("kind")
                if str(e.get("origin")) != origin:
                    continue
                s = None
                if k == "delta.apply":
                    s = e.get("dseq")
                elif k == "snap.apply":
                    s = e.get("step")
                elif k == "psnap.resync":
                    s = e.get("dig_seq")
                if s is not None:
                    survivor_floor = max(survivor_floor, int(s))
        max_acked = max((s for s, _l, _w in hard), default=-1)
        cover = max(durable_floor, recover_floor, survivor_floor)
        if clean:
            cover = max(cover, max_acked)
        per_origin[origin] = {
            "acked_through": max_acked,
            "n_hard_acks": len(hard),
            "clean_exit": clean,
            "durable_floor": durable_floor,
            "recover_floor": recover_floor,
            "survivor_floor": survivor_floor,
            "covered_through": cover,
        }
        if max_acked > cover:
            exposures.append({
                "origin": origin,
                "acked_through": max_acked,
                "covered_through": cover,
                "uncovered": [cover + 1, max_acked],
                "lost_write_ids": sorted(
                    wid for s, _l, wid in hard if s > cover and wid
                )[:8],
            })
    # -- duplication: one ingest.fold per write_id, fleet-wide ---------
    folds: Dict[str, List[Dict[str, Any]]] = {}
    for fname in sorted(logs):
        evs = logs[fname]
        applier = next(
            (str(e["member"]) for e in evs if e.get("member")), fname
        )
        for e in evs:
            if e.get("kind") != "ingest.fold" or not e.get("write_id"):
                continue
            folds.setdefault(str(e["write_id"]), []).append(
                {"member": str(e.get("member") or applier),
                 "wseq": int(e.get("wseq", -1))}
            )
    dup_examples = [
        {"write_id": wid, "folds": sites}
        for wid, sites in sorted(folds.items())
        if len(sites) > 1
    ]
    duplicates = {
        "n_folded_write_ids": len(folds),
        "n_duplicated": len(dup_examples),
        "examples": dup_examples[:8],
    }
    checks = {"acked_durability_coverage": not exposures}
    if strict_exactly_once:
        checks["exactly_once_application"] = not dup_examples
    ok = all(checks.values())
    doc: Dict[str, Any] = {
        "kind": WRITE_CERTIFICATE_KIND,
        "version": WRITE_CERTIFICATE_VERSION,
        "t": round(time.time(), 3),
        "ok": ok,
        "checks": checks,
        "n_acks": n_acks,
        "acks_by_level": by_level,
        "n_origins": len(acks),
        "origins": per_origin,
        "duplicates": duplicates,
        "n_flight_logs": len(logs),
        "meta": meta or {},
    }
    if not ok:
        cx: Dict[str, Any] = {}
        if exposures:
            cx["acked_but_lost"] = exposures[:5]
        if strict_exactly_once and dup_examples:
            cx["duplicate_applications"] = dup_examples[:5]
        doc["counterexample"] = cx
    sign_certificate(doc)
    obs_events.emit(
        "audit.write_certificate", ok=ok,
        n_exposed=len(exposures),
        n_duplicated=len(dup_examples),
        signature=doc["signature"][:16],
    )
    return doc


# -- lattice-law checking ----------------------------------------------------


class LawChecker:
    """Run the merge/delta law suite for every registered dense type.

    Fixtures come from the registry (`Registry.law_fixture`), so each
    type supplies its own reachable-state generator; `extra_fixtures`
    lets a caller inject unregistered ones — the negative selftest
    (`ops.laws.broken_merge_fixture`) enters that way and MUST fail.
    `pairs` is the instance-grid width: one merge dispatch checks that
    many instance pairs. Types on the registry with no fixture land in
    `unaudited` and flip `ok` False — a new type cannot silently skip
    the gate. Each fixture builds its states on `device` (the port's
    fixtures default to the CUDA card; ``device="cpu"`` checks on the
    host)."""

    def __init__(
        self,
        types: Optional[Sequence[str]] = None,
        seed: int = 0,
        pairs: int = 512,
        extra_fixtures: Optional[Dict[str, Callable[..., Any]]] = None,
        metrics: Any = None,
        device: Any = None,
    ) -> None:
        self.types = list(types) if types is not None else None
        self.device = device
        self.seed = int(seed)
        self.pairs = max(1, int(pairs))
        self.extra_fixtures = dict(extra_fixtures or {})
        self.metrics = metrics

    def run(self) -> Dict[str, Any]:
        from ..core.behaviour import registry
        from ..ops import laws  # lazy: pulls torch + registers fixtures

        wanted = (
            set(self.types) if self.types is not None
            else set(registry.dense_types()) | set(self.extra_fixtures)
        )
        fixtures: Dict[str, Any] = {
            name: fx
            for name, fx in registry.law_fixtures().items()
            if name in wanted
        }
        fixtures.update(
            (n, f) for n, f in self.extra_fixtures.items() if n in wanted
        )
        unaudited = sorted(wanted - set(fixtures))

        types_out: Dict[str, Any] = {}
        n_checks = n_failures = 0
        for name in sorted(fixtures):
            spec = fixtures[name](self.seed, self.pairs, device=self.device)
            rep = laws.check_engine_laws(
                spec["dense"], spec["states"], spec.get("chain")
            )
            types_out[name] = rep
            n_checks += len(rep["laws"])
            n_failures += sum(
                1 for e in rep["laws"].values() if not e["ok"]
            )
        report = {
            "ok": not unaudited and all(r["ok"] for r in types_out.values()),
            "pairs": self.pairs,
            "seed": self.seed,
            "n_types": len(types_out),
            "n_law_checks": n_checks,
            "n_law_failures": n_failures,
            "unaudited": unaudited,
            "types": types_out,
        }
        if self.metrics is not None:
            self.metrics.count("audit.law_checks", float(n_checks))
            if n_failures:
                self.metrics.count("audit.law_failures", float(n_failures))
        obs_events.emit(
            "audit.laws", ok=report["ok"], n_types=len(types_out),
            n_checks=n_checks, n_failures=n_failures,
            unaudited=unaudited,
        )
        return report


# -- live divergence watchdog ------------------------------------------------


def _div_parts(own: Any, peer: Any) -> List[int]:
    """Indices where two digest vectors disagree (scalar digests compare
    as 1-vectors; incomparable lengths flag every index)."""
    a = list(own) if hasattr(own, "__len__") else [own]
    b = list(peer) if hasattr(peer, "__len__") else [peer]
    if len(a) != len(b):
        return list(range(max(len(a), len(b))))
    return [i for i in range(len(a)) if int(a[i]) != int(b[i])]


class DivergenceWatchdog:
    """Per-peer divergence state machine over the digest vectors the
    partial anti-entropy tier already fetches.

    States: 0 ok, 1 diverged, 2 wedged. A peer enters `diverged` the
    first observation its vector disagrees with ours — i.e. within one
    digest-exchange round of the divergence existing. Divergence is
    NORMAL in steady state (ops in flight); the alarm condition is
    *wedged*: still diverged after `wedge_after_s` seconds with no
    repair progress (progress = the divergent set shrinking, or the
    anti-entropy tier reporting applied psnaps via
    `note_repair_progress`). Agreement closes the episode and records a
    time-to-agreement sample.

    Everything is monotonic-clock based (injectable for tests); gauges
    and counters land on the supplied `Metrics` so the existing scrape
    surfaces export them; transitions emit `audit.*` flight events."""

    STATE_OK, STATE_DIVERGED, STATE_WEDGED = 0, 1, 2
    _STATE_NAMES = {0: "ok", 1: "diverged", 2: "wedged"}

    def __init__(
        self,
        member: str,
        wedge_after_s: float = 5.0,
        mono: Callable[[], float] = time.monotonic,
        metrics: Any = None,
        max_tta_samples: int = 256,
    ) -> None:
        self.member = member
        self.wedge_after_s = float(wedge_after_s)
        self._mono = mono
        self.metrics = metrics
        self._max_tta = max(1, int(max_tta_samples))
        # peer -> {"state", "since", "progress", "parts", "seq"}
        self._peers: Dict[str, Dict[str, Any]] = {}
        self._tta: List[float] = []
        self.last_certificate: Optional[Dict[str, Any]] = None

    # -- feeding ----------------------------------------------------------

    def observe_peer(
        self, peer: str, own_vec: Any, peer_vec: Any,
        seq: Optional[int] = None,
    ) -> int:
        """One digest exchange with `peer`: compare vectors, advance the
        state machine, export gauges. Returns the peer's state."""
        now = self._mono()
        div = _div_parts(own_vec, peer_vec)
        rec = self._peers.get(peer)
        if div:
            if rec is None or rec["state"] == self.STATE_OK:
                rec = {
                    "state": self.STATE_DIVERGED, "since": now,
                    "progress": now, "parts": div, "seq": seq,
                }
                self._peers[peer] = rec
                self._count("audit.divergences")
                obs_events.emit(
                    "audit.divergence", peer=peer, parts=div, dig_seq=seq,
                )
            else:
                if set(div) < set(rec["parts"]):
                    # Strictly shrinking divergence = repair landing.
                    rec["progress"] = now
                rec["parts"], rec["seq"] = div, seq
                if (
                    rec["state"] == self.STATE_DIVERGED
                    and now - rec["progress"] > self.wedge_after_s
                ):
                    rec["state"] = self.STATE_WEDGED
                    self._count("audit.wedge_alarms")
                    obs_events.emit(
                        "audit.wedged", peer=peer, parts=div,
                        age_s=round(now - rec["since"], 3), dig_seq=seq,
                    )
        else:
            if rec is not None and rec["state"] != self.STATE_OK:
                tta = now - rec["since"]
                self._tta.append(tta)
                del self._tta[: -self._max_tta]
                self._count("audit.agreements")
                obs_events.emit(
                    "audit.agreement", peer=peer,
                    tta_s=round(tta, 6), dig_seq=seq,
                )
            self._peers[peer] = {
                "state": self.STATE_OK, "since": now, "progress": now,
                "parts": [], "seq": seq,
            }
        self._export()
        return self._peers[peer]["state"]

    def note_repair_progress(self, peer: str) -> None:
        """The anti-entropy tier applied repair payloads for `peer` —
        resets the wedge clock (a slow-but-moving repair is not wedged)."""
        rec = self._peers.get(peer)
        if rec is not None:
            rec["progress"] = self._mono()

    def drop(self, peer: str) -> None:
        """Forget a DEAD peer (SWIM verdict): its frozen digest vector
        must not age into a phantom wedge alarm."""
        self._peers.pop(peer, None)
        self._export()

    def note_certificate(self, cert: Dict[str, Any]) -> None:
        """Record the last convergence certificate for the health/status
        surfaces."""
        self.last_certificate = {
            "ok": bool(cert.get("ok")),
            "signature": str(cert.get("signature", ""))[:16],
            "t": cert.get("t"),
        }
        if self.metrics is not None:
            self.metrics.set(
                "audit.certificate_ok", 1.0 if cert.get("ok") else 0.0
            )

    # -- reading ----------------------------------------------------------

    def state(self) -> int:
        return max(
            (r["state"] for r in self._peers.values()),
            default=self.STATE_OK,
        )

    def divergence_age_s(self) -> float:
        now = self._mono()
        return max(
            (
                now - r["since"] for r in self._peers.values()
                if r["state"] != self.STATE_OK
            ),
            default=0.0,
        )

    def divergent_parts(self) -> List[int]:
        parts: set = set()
        for r in self._peers.values():
            if r["state"] != self.STATE_OK:
                parts.update(r["parts"])
        return sorted(parts)

    def tta_p50_s(self) -> Optional[float]:
        if not self._tta:
            return None
        vals = sorted(self._tta)
        return vals[(len(vals) - 1) // 2]

    def peers(self) -> Dict[str, Dict[str, Any]]:
        return {
            p: {
                "state": self._STATE_NAMES[r["state"]],
                "parts": list(r["parts"]),
                "dig_seq": r["seq"],
            }
            for p, r in sorted(self._peers.items())
        }

    # -- exporting --------------------------------------------------------

    def _count(self, name: str) -> None:
        if self.metrics is not None:
            self.metrics.count(name)

    def _export(self) -> None:
        if self.metrics is None:
            return
        self.metrics.set("audit.watchdog_state", float(self.state()))
        self.metrics.set(
            "audit.divergence_age_seconds", round(self.divergence_age_s(), 6)
        )
        p50 = self.tta_p50_s()
        if p50 is not None:
            self.metrics.set("audit.tta_p50_seconds", round(p50, 6))

    def health_fields(self) -> Dict[str, Any]:
        """/healthz verdict fields (merged via the never-fatal
        `health_extra` probe in obs/http.py)."""
        out: Dict[str, Any] = {
            "audit_watchdog_state": self._STATE_NAMES[self.state()],
            "audit_divergence_age_s": round(self.divergence_age_s(), 3),
            "audit_divergent_parts": self.divergent_parts(),
        }
        p50 = self.tta_p50_s()
        if p50 is not None:
            out["audit_tta_p50_ms"] = round(1000.0 * p50, 3)
        if self.last_certificate is not None:
            out["audit_last_certificate"] = dict(self.last_certificate)
        return out

    def status_fields(self) -> Dict[str, Any]:
        """Compact block for the per-worker status drops the dashboard
        scrapes (obs-<member>.json)."""
        p50 = self.tta_p50_s()
        return {
            "state": self._STATE_NAMES[self.state()],
            "age_s": round(self.divergence_age_s(), 3),
            "tta_p50_ms": (
                round(1000.0 * p50, 3) if p50 is not None else None
            ),
            "ttas": len(self._tta),
            "cert_ok": (
                None if self.last_certificate is None
                else self.last_certificate["ok"]
            ),
        }
