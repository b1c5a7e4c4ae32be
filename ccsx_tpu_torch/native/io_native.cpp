// ccsx_tpu native IO: gzip-streamed FASTA/FASTQ + BAM readers and the
// ZMW group-by-hole streamer, as a C shared library consumed via ctypes.
//
// This is the [NATIVE] L1 of the framework (SURVEY.md §7.1 io_native),
// re-implementing the semantics of the reference's IO stack:
//   * FASTA/FASTQ state machine  — kseq.h:177-218 (records at '>'/'@',
//     multi-line seq, '+' quality section read until length match);
//   * BAM record walk            — bamlite.c:78-165 (BAM-through-gzip,
//     magic+header parse, record parse, 4-bit nibble seq decode via the
//     =ACMGRSVTWYHKDBN table bamlite.h:86/seqio.h:92, qual phred+33
//     clamped at 126 seqio.h:113);
//   * ZMW group-by-hole streamer — seqio.h:152-201 (name split on '/'
//     expecting movie/hole/region, consecutive same-hole records
//     concatenated, one-record lookahead carry);
//   * read-step filters          — main.c:659-672 (min pass count, total
//     length bounds); hole exclusion stays host-side (tiny set, rare).
//   * 2-bit encode / reverse-complement tables — main.c:222-241,
//     seqio.h:120-148.
//
// Ownership: all pointers returned through the API reference buffers owned
// by the reader handle and are valid until the next next_* call on that
// handle. The Python wrapper copies them out immediately.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kBufSize = 1 << 16;

// ---- corruption taxonomy + salvage accounting ----------------------------
//
// Mirrors io/corruption.py: the reason codes, the allocation bound, the
// BGZF block-resync rules, and the plausible-record scan are a shared
// contract — the differential fuzz tests (tests/test_fuzz_ingest.py)
// hold the two stacks to the same classification and the same salvaged
// record set on the same mutant.

constexpr int64_t kDefaultMaxRecordBytes = 256LL * 1024 * 1024;
constexpr int64_t kMinRecordBlock = 34;     // 32 fixed + 2-byte name
constexpr int64_t kScanLookahead = 4 + 32 + 255;

struct Salvage {
  bool on = false;
  int64_t max_record_bytes = kDefaultMaxRecordBytes;
  // events/exempt are read live across the ctypes boundary (the
  // prefetch consumer polls while the producer parses) — atomic; the
  // full reason buckets are only summarized after EOF.  exempt counts
  // the budget-exempt reasons (corruption.NON_BUDGET_REASONS — today
  // only bgzf_missing_eof) so a --max-failed-holes check on holes
  // yielded AFTER the event but BEFORE EOF cannot misread a zero-loss
  // degradation as a lost hole.
  std::atomic<int64_t> events{0};
  std::atomic<int64_t> exempt{0};
  std::map<std::string, int64_t> counts;
  std::string summary;   // built by build_summary(), owned here

  void record(const char* reason) {
    events.fetch_add(1, std::memory_order_relaxed);
    if (std::strcmp(reason, "bgzf_missing_eof") == 0)
      exempt.fetch_add(1, std::memory_order_relaxed);
    counts[reason]++;
  }
  const char* build_summary() {
    summary.clear();
    for (const auto& kv : counts) {
      if (!summary.empty()) summary.push_back(',');
      summary += kv.first;
      summary.push_back(':');
      summary += std::to_string(kv.second);
    }
    return summary.c_str();
  }
};

// ---- decode tables -------------------------------------------------------

// 4-bit BAM code -> ASCII (bamlite.h:86, seqio.h:92)
const char kNt16[] = "=ACMGRSVTWYHKDBN";

struct Tables {
  uint8_t enc[256];      // ASCII -> 0..3 base, 4 other
  uint8_t comp[256];     // ASCII complement (seqio.h:120-137)
  uint8_t nib[256][2];   // packed byte -> two ASCII bases
  Tables() {
    for (int i = 0; i < 256; i++) enc[i] = 4;
    const char* b = "ACGT";
    for (int i = 0; i < 4; i++) {
      enc[(uint8_t)b[i]] = (uint8_t)i;
      enc[(uint8_t)(b[i] + 32)] = (uint8_t)i;
    }
    for (int i = 0; i < 256; i++) comp[i] = (uint8_t)i;
    const char* from = "ACGTacgtUuNn";
    const char* to = "TGCAtgcaAaNn";
    for (int i = 0; from[i]; i++) comp[(uint8_t)from[i]] = (uint8_t)to[i];
    for (int i = 0; i < 256; i++) {
      nib[i][0] = (uint8_t)kNt16[i >> 4];
      nib[i][1] = (uint8_t)kNt16[i & 0xF];
    }
  }
};
const Tables kT;

// ---- BGZF block-parallel inflate -----------------------------------------
//
// Real subreads.bam files are BGZF: gzip members <=64KB each carrying a
// "BC" extra subfield with the compressed block size.  The reference reads
// them as one sequential gzip stream (bamlite.h:13-19 uses the plain gz
// API), which caps ingest at single-thread inflate speed — SURVEY.md §7.3
// item 6 flags multithreaded BGZF inflate as load-bearing for the 8x
// target.  This reader parses block boundaries from the BC field, hands
// whole compressed members to a worker pool, and delivers decompressed
// blocks in file order.  Threads: CCSX_BGZF_THREADS or
// hardware_concurrency clamped to [1, 8]; at 1, inflate runs inline
// (no pool) so single-core machines pay no synchronization.

struct BgzfMT {
  struct Job {
    std::vector<uint8_t> comp;   // raw deflate payload (no hdr/crc)
    std::vector<uint8_t> out;
    uint32_t crc = 0, isize = 0;
    bool done = false, bad = false;
    bool gap_before = false;     // salvage: dropped bytes precede this
  };

  FILE* f = nullptr;
  bool raw_eof = false, err = false;
  const char* err_reason = nullptr;  // taxonomy code for err (fail-fast)
  bool last_was_eof_marker = false;  // saw the 28-byte empty EOF block
  Salvage* sv = nullptr;             // non-null + on = salvage mode
  long file_size = -1;               // computed lazily for salvage scans
  bool gap_pending = false;          // skipped data since the last job
  bool pending_gap_out = false;      // job dropped at delivery time
  bool end_counted = false;          // torn-tail end event booked once
  int nthreads = 1;
  size_t depth = 64;                         // blocks in flight
  std::deque<std::shared_ptr<Job>> order;    // file order
  std::deque<std::shared_ptr<Job>> queue;    // pending work
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::vector<std::thread> workers;
  bool shutdown = false;

  static int env_threads() {
    const char* e = getenv("CCSX_BGZF_THREADS");
    // clamp explicit values too: an absurd count would throw
    // std::system_error from thread creation with no handler across
    // the ctypes boundary (std::terminate).  64 is far above any
    // useful inflate parallelism but far below failure territory,
    // so legitimate big-host settings are honored
    if (e && *e) return std::min(std::max(1, atoi(e)), 64);
    unsigned hc = std::thread::hardware_concurrency();
    return hc > 1 ? (int)std::min(hc, 8u) : 1;
  }

  void open(FILE* file) {
    f = file;
    nthreads = env_threads();
    for (int i = 1; i < nthreads; i++)
      workers.emplace_back([this] { worker(); });
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu);
      shutdown = true;
    }
    cv_work.notify_all();
    for (auto& t : workers) t.join();
    workers.clear();
    if (f) { fclose(f); f = nullptr; }
  }

  static bool inflate_job(Job* j) {
    uint8_t scratch = 0;
    j->out.resize(j->isize);
    z_stream zs;
    std::memset(&zs, 0, sizeof zs);
    if (inflateInit2(&zs, -15) != Z_OK) return false;
    zs.next_in = j->comp.data();
    zs.avail_in = (uInt)j->comp.size();
    zs.next_out = j->isize ? j->out.data() : &scratch;
    zs.avail_out = j->isize ? (uInt)j->out.size() : 1;
    int rc = inflate(&zs, Z_FINISH);
    bool ok = rc == Z_STREAM_END && zs.total_out == j->isize;
    inflateEnd(&zs);
    if (ok && j->isize &&
        crc32(crc32(0, Z_NULL, 0), j->out.data(), (uInt)j->out.size())
            != j->crc)
      ok = false;
    return ok;
  }

  void worker() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      cv_work.wait(lk, [this] { return shutdown || !queue.empty(); });
      if (queue.empty()) {
        if (shutdown) return;
        continue;
      }
      auto j = queue.front();
      queue.pop_front();
      lk.unlock();
      bool ok = inflate_job(j.get());
      lk.lock();
      j->bad = !ok;
      j->done = true;
      cv_done.notify_all();
    }
  }

  bool salv() const { return sv != nullptr && sv->on; }

  long fsize() {
    if (file_size < 0) {
      long cur = std::ftell(f);
      std::fseek(f, 0, SEEK_END);
      file_size = std::ftell(f);
      std::fseek(f, cur, SEEK_SET);
    }
    return file_size;
  }

  // salvage resync candidate check at `cand` (mirrors the Python
  // rescan in io/bam.py _bgzf_salvage_chunks: magic + FEXTRA + a BC
  // subfield whose BSIZE chains exactly to EOF or to another magic)
  bool try_candidate(long cand, long sz) {
    std::fseek(f, cand, SEEK_SET);
    uint8_t hdr[12];
    if (fread(hdr, 1, 12, f) != 12) return false;
    if (!(hdr[0] == 0x1f && hdr[1] == 0x8b && hdr[2] == 8 &&
          (hdr[3] & 4)))
      return false;
    uint16_t xlen = (uint16_t)(hdr[10] | (hdr[11] << 8));
    std::vector<uint8_t> extra(xlen);
    if (fread(extra.data(), 1, xlen, f) != xlen) return false;
    int64_t bsize = -1;
    for (size_t i = 0; i + 4 <= extra.size();) {
      uint16_t slen = (uint16_t)(extra[i + 2] | (extra[i + 3] << 8));
      if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2 &&
          i + 6 <= extra.size()) {
        bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
        break;
      }
      i += 4 + slen;
    }
    if (bsize < (int64_t)(12 + xlen + 8)) return false;
    if (cand + bsize > sz) return false;
    if (cand + bsize == sz) return true;
    std::fseek(f, cand + bsize, SEEK_SET);
    uint8_t m[3];
    if (fread(m, 1, 3, f) != 3) return false;
    return m[0] == 0x1f && m[1] == 0x8b && m[2] == 8;
  }

  // scan forward from `from` for the next valid chained block header;
  // repositions f and returns true, or false when none remains
  bool rescan_from(long from) {
    long sz = fsize();
    uint8_t w[4096];
    for (long o = from; o + 12 <= sz;) {
      std::fseek(f, o, SEEK_SET);
      size_t n = fread(w, 1, sizeof w, f);
      if (n < 3) break;
      for (size_t i = 0; i + 3 <= n; i++) {
        if (w[i] == 0x1f && w[i + 1] == 0x8b && w[i + 2] == 0x08) {
          long cand = o + (long)i;
          if (try_candidate(cand, sz)) {
            std::fseek(f, cand, SEEK_SET);
            return true;
          }
        }
      }
      o += (long)(n >= 2 ? n - 2 : n);  // overlap: magic spans reads
    }
    return false;
  }

  // parse one raw BGZF member from f; null at EOF (err set on a
  // malformed header/truncation — or, in salvage mode, the damage is
  // classified, the stream resyncs on the next valid chained block
  // header, and the next job carries gap_before)
  std::shared_ptr<Job> read_raw() {
    for (;;) {
      long start = salv() ? std::ftell(f) : 0;
      uint8_t hdr[12];
      size_t n = fread(hdr, 1, 12, f);
      if (n == 0) { raw_eof = true; return nullptr; }
      bool hdr_ok = n == 12 && hdr[0] == 0x1f && hdr[1] == 0x8b &&
                    hdr[2] == 8 && (hdr[3] & 4);
      uint16_t xlen = 0;
      std::vector<uint8_t> extra;
      int64_t bsize = -1;
      if (hdr_ok) {
        xlen = (uint16_t)(hdr[10] | (hdr[11] << 8));
        extra.resize(xlen);
        if (fread(extra.data(), 1, xlen, f) != xlen) {
          hdr_ok = false;
        } else {
          for (size_t i = 0; i + 4 <= extra.size();) {
            uint16_t slen = (uint16_t)(extra[i + 2] | (extra[i + 3] << 8));
            if (extra[i] == 'B' && extra[i + 1] == 'C' && slen == 2 &&
                i + 6 <= extra.size()) {
              bsize = (extra[i + 4] | (extra[i + 5] << 8)) + 1;
              break;
            }
            i += 4 + slen;
          }
          if (bsize < (int64_t)(12 + xlen + 8)) hdr_ok = false;
        }
      }
      if (hdr_ok && salv() && start + bsize > fsize()) hdr_ok = false;
      if (!hdr_ok) {
        if (!salv()) {
          err = true; raw_eof = true;
          err_reason = n < 12 ? "bgzf_torn_tail" : "bgzf_bad_block";
          return nullptr;
        }
        // classification mirrors io/bam.py: fewer than a full fixed
        // header left (or a block running past EOF) = torn tail,
        // otherwise a damaged block header
        sv->record(n < 12 || (bsize >= (int64_t)(12 + xlen + 8) &&
                              start + bsize > fsize())
                       ? "bgzf_torn_tail" : "bgzf_bad_block");
        last_was_eof_marker = false;
        if (!rescan_from(start + 1)) { raw_eof = true; return nullptr; }
        gap_pending = true;
        continue;
      }
      size_t payload = (size_t)(bsize - 12 - xlen - 8);
      auto j = std::make_shared<Job>();
      j->comp.resize(payload);
      uint8_t tail[8];
      if (fread(j->comp.data(), 1, payload, f) != payload ||
          fread(tail, 1, 8, f) != 8) {
        // non-salvage can reach this on streams where fsize() was not
        // consulted; classification parity keeps it torn-tail
        if (!salv()) {
          err = true; raw_eof = true;
          err_reason = "bgzf_torn_tail";
          return nullptr;
        }
        sv->record("bgzf_torn_tail");
        last_was_eof_marker = false;
        raw_eof = true;
        return nullptr;
      }
      std::memcpy(&j->crc, tail, 4);
      std::memcpy(&j->isize, tail + 4, 4);
      last_was_eof_marker = payload <= 4 && j->isize == 0;
      // BGZF caps the uncompressed block at 64KB; a larger ISIZE is
      // file corruption — reject it here rather than letting
      // inflate_job value-initialize an attacker-sized buffer
      if (j->isize > (1u << 16)) {
        if (!salv()) {
          err = true; raw_eof = true;
          err_reason = "bgzf_bad_deflate";
          return nullptr;
        }
        sv->record("bgzf_bad_deflate");
        gap_pending = true;
        continue;
      }
      j->gap_before = gap_pending;
      gap_pending = false;
      return j;
    }
  }

  // next decompressed block into *dst: size, 0 = clean EOF, -1 = error.
  // *gap_before (may be null) reports salvage-dropped bytes preceding
  // this block's data.
  int64_t next_block(std::vector<uint8_t>* dst, bool* gap_before) {
    if (gap_before) *gap_before = false;
    for (;;) {
      while (!raw_eof && order.size() < depth) {
        auto j = read_raw();
        if (!j) break;
        order.push_back(j);
        if (workers.empty()) {
          j->bad = !inflate_job(j.get());
          j->done = true;
        } else {
          {
            std::lock_guard<std::mutex> lk(mu);
            queue.push_back(j);
          }
          cv_work.notify_one();
        }
      }
      if (order.empty()) {
        // a clean BGZF stream ends with the empty EOF-marker block
        // (write_bgzf/htslib emit it); missing it means the file was
        // truncated at a block boundary — surface that as an error
        // (or, in salvage mode, one classified torn-tail event)
        if (!err && !last_was_eof_marker) {
          if (salv()) {
            // budget-exempt reason (corruption.NON_BUDGET_REASONS):
            // a healthy file that merely lost its marker emits every
            // hole intact
            if (!end_counted) {
              end_counted = true;
              sv->record("bgzf_missing_eof");
            }
          } else {
            err = true;
            err_reason = "bgzf_missing_eof";
          }
        }
        return err ? -1 : 0;
      }
      auto j = order.front();
      order.pop_front();
      if (!workers.empty()) {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [&] { return j->done; });
      }
      if (j->bad) {
        if (salv()) {
          sv->record("bgzf_bad_deflate");
          pending_gap_out = true;
          continue;
        }
        err = true;
        err_reason = "bgzf_bad_deflate";
        return -1;
      }
      if (j->out.empty()) {           // empty block (e.g. EOF marker)
        pending_gap_out |= j->gap_before;
        continue;
      }
      if (gap_before) *gap_before = j->gap_before || pending_gap_out;
      pending_gap_out = false;
      dst->swap(j->out);
      return (int64_t)dst->size();
    }
  }
};

// ---- buffered gz stream --------------------------------------------------

struct GzStream {
  gzFile gz = nullptr;
  std::unique_ptr<BgzfMT> bgzf;  // non-null: BGZF block-parallel mode
  std::vector<uint8_t> buf;
  int64_t begin = 0, end = 0;
  bool eof = false;
  bool err = false;  // corrupt/truncated gzip stream (gzread < 0)
  const char* err_reason = nullptr;  // taxonomy code for err
  Salvage* sv = nullptr;
  // salvage: the CURRENT buffer is preceded by dropped (damaged)
  // bytes; consumers must not parse across the boundary.  gap_events
  // counts deliveries for readers that only need "did one happen".
  bool gap_before = false;
  int64_t gap_events = 0;

  bool salv() const { return sv != nullptr && sv->on; }

  void set_salvage(Salvage* s) {
    sv = s;
    if (bgzf) bgzf->sv = s;
  }

  bool open(const char* path) {
    if (std::strcmp(path, "-") != 0) {
      // sniff BGZF (regular files only; stdin can't rewind): gzip magic
      // + FEXTRA with a leading BC subfield, as htslib writes it
      FILE* f = fopen(path, "rb");
      if (!f) return false;
      uint8_t m[14];
      size_t n = fread(m, 1, sizeof m, f);
      bool is_bgzf = n == sizeof m && m[0] == 0x1f && m[1] == 0x8b &&
                     m[2] == 8 && (m[3] & 4) && m[12] == 'B' &&
                     m[13] == 'C';
      if (is_bgzf) {
        std::fseek(f, 0, SEEK_SET);
        bgzf.reset(new BgzfMT());
        bgzf->open(f);
        return true;
      }
      std::fclose(f);
    }
    if (std::strcmp(path, "-") == 0)
      gz = gzdopen(0, "r");
    else
      gz = gzopen(path, "r");
    if (gz) { buf.resize(kBufSize); return true; }
    return false;
  }
  void close() {
    if (gz) { gzclose(gz); gz = nullptr; }
    if (bgzf) { bgzf->close(); bgzf.reset(); }
  }
  bool fill() {
    if (eof) return false;
    if (bgzf) {
      bool gap = false;
      int64_t n = bgzf->next_block(&buf, &gap);
      begin = 0;
      end = n > 0 ? n : 0;
      if (gap) { gap_before = true; gap_events++; }
      if (n < 0) {
        eof = true; err = true;
        err_reason = bgzf->err_reason;
        return false;
      }
      if (n == 0) { eof = true; return false; }
      return true;
    }
    int n = gzread(gz, buf.data(), (unsigned)buf.size());
    begin = 0;
    end = n > 0 ? n : 0;
    if (n < 0) {
      eof = true; err = true;
      err_reason = "gzip_truncated";
      // a broken deflate stream has no block structure to resync on:
      // salvage classifies it once and ends the stream (the records
      // already delivered are the salvage)
      if (salv()) sv->record("gzip_truncated");
      return false;
    }
    if (n == 0) {
      // distinguish clean EOF from a truncated deflate stream
      int errnum = Z_OK;
      gzerror(gz, &errnum);
      if (errnum != Z_OK && errnum != Z_STREAM_END) {
        err = true;
        err_reason = "gzip_truncated";
        if (salv()) sv->record("gzip_truncated");
      }
      eof = true;
      return false;
    }
    return true;
  }
  // next byte or -1 at EOF
  int getc() {
    if (begin >= end && !fill()) return -1;
    return buf[begin++];
  }
  // read exactly n bytes; returns bytes read
  int64_t read(uint8_t* dst, int64_t n) {
    int64_t got = 0;
    while (got < n) {
      if (begin >= end && !fill()) break;
      int64_t take = end - begin;
      if (take > n - got) take = n - got;
      std::memcpy(dst + got, buf.data() + begin, (size_t)take);
      begin += take;
      got += take;
    }
    return got;
  }
  // append bytes into `out` until delimiter class hit (dropped from out).
  // delim: 0 = isspace, 1 = line ('\n', with '\r' stripped by caller).
  // returns: >=0 delimiter byte consumed, -1 EOF (out may hold a tail).
  int getuntil(int delim, std::string* out) {
    for (;;) {
      if (begin >= end && !fill()) return -1;
      int64_t i = begin;
      if (delim == 0) {
        while (i < end && !isspace(buf[i])) i++;
      } else {
        while (i < end && buf[i] != '\n') i++;
      }
      out->append((const char*)buf.data() + begin, (size_t)(i - begin));
      if (i < end) {
        int c = buf[i];
        begin = i + 1;
        return c;
      }
      begin = i;
    }
  }
};

// ---- record (one subread) ------------------------------------------------

struct Record {
  std::string name, comment, seq, qual;
  bool has_qual = false;
  void clear() {
    name.clear(); comment.clear(); seq.clear(); qual.clear();
    has_qual = false;
  }
};

// ---- FASTA/FASTQ reader (kseq.h:177-218 semantics) ----------------------

struct FastxReader {
  GzStream s;
  int last_char = 0;  // 0 = need to scan for marker; else the marker byte
  Salvage* sv = nullptr;

  bool salv() const { return sv != nullptr && sv->on; }

  // salvage resync: skip to the next line STARTING with '>'/'@' (the
  // line-anchored rule io/fastx.py uses — a '@' inside a quality line
  // must not anchor).  Called at a line boundary.
  void line_resync() {
    for (;;) {
      int c = s.getc();
      if (c == -1) { last_char = 0; return; }
      if (c == '>' || c == '@') { last_char = c; return; }
      // a blank line: the consumed '\n' already leaves us at the next
      // line start — consuming another line here would swallow a
      // record header after a blank line (io/fastx.py keeps it)
      if (c == '\n') continue;
      std::string skip;
      if (s.getuntil(1, &skip) == -1) { last_char = 0; return; }
    }
  }

  // returns: 1 record, 0 EOF, -2 malformed (qual length mismatch),
  // -3 corrupt gzip stream.  Salvage mode never returns -2/-3: the
  // corruption is classified, the parser resyncs, and the next good
  // record (or EOF) is returned.
  int next(Record* r) {
    for (;;) {
      int rc = next_impl(r);
      if (rc != -9) return rc;   // -9 = salvage drop, retry
    }
  }

  int next_impl(Record* r) {
    r->clear();
    int64_t gap0 = s.gap_events;
    int c = last_char;
    if (c == 0) {
      while ((c = s.getc()) != -1 && c != '>' && c != '@') {}
      if (c == -1) return (s.err && !salv()) ? -3 : 0;
    }
    last_char = 0;
    int marker = c;
    // name = first whitespace token; comment = rest of line
    c = s.getuntil(0, &r->name);
    if (c == -1) {
      if (s.err && !salv()) return -3;
      if (r->name.empty()) return 0;
      return finish_record(r, marker, gap0, false);
    }
    if (c != '\n') {
      c = s.getuntil(1, &r->comment);
      // byte-parity with io/fastx.py: strip only line terminators; keep
      // any interior/trailing spaces exactly as Python's split(None, 1)
      while (!r->comment.empty() && r->comment.back() == '\r')
        r->comment.pop_back();
      // leading whitespace from the delimiter run
      size_t b = 0;
      while (b < r->comment.size() &&
             (r->comment[b] == ' ' || r->comment[b] == '\t' ||
              r->comment[b] == '\r'))
        b++;
      r->comment.erase(0, b);
    }
    // sequence lines until '>', '@' or '+'
    while ((c = s.getc()) != -1 && c != '>' && c != '@' && c != '+') {
      if (c == '\n' || c == '\r') continue;
      r->seq.push_back((char)c);
      std::string tmp;
      int d = s.getuntil(1, &tmp);
      while (!tmp.empty() && tmp.back() == '\r') tmp.pop_back();
      r->seq.append(tmp);
      if (d == -1) { c = -1; break; }
    }
    if (c == '>' || c == '@') {
      last_char = c;
      return finish_record(r, marker, gap0, false);
    }
    if (s.err && !salv()) return -3;    // truncated gzip mid-sequence
    if (c != '+') return finish_record(r, marker, gap0, false);
    // '+' line: skip to end of line, then read quality until length match
    {
      std::string skip;
      if (s.getuntil(1, &skip) == -1) {
        if (!salv()) return -2;
        if (r->seq.empty()) return finish_record(r, marker, gap0, true);
        sv->record("fastx_truncated");
        return 0;   // EOF: nothing to resync onto
      }
    }
    while (r->qual.size() < r->seq.size()) {
      std::string line;
      int d = s.getuntil(1, &line);
      while (!line.empty() && line.back() == '\r') line.pop_back();
      r->qual.append(line);
      if (d == -1) break;
    }
    if (s.err && !salv()) return -3;
    if (r->qual.size() != r->seq.size()) {
      if (!salv()) return -2;
      // shorter = the stream ended under the record; longer = a
      // damaged quality section (mirrors io/fastx.py)
      sv->record(r->qual.size() < r->seq.size() ? "fastx_truncated"
                                                : "fastx_qual_mismatch");
      line_resync();
      return -9;
    }
    return finish_record(r, marker, gap0, true);
  }

  int finish_record(Record* r, int marker, int64_t gap0, bool has_q) {
    if (salv() && s.gap_events != gap0) {
      // the record's bytes span a BGZF salvage gap: a chimera of two
      // damaged regions — drop it and re-anchor (the gap itself was
      // already classified by the block layer)
      line_resync();
      return -9;
    }
    if (has_q) {
      // kseq parity: the quality section is *parsed* after any record,
      // but reported only for '@' records (io/fastx.py does the same).
      r->has_qual = (marker == '@');
      if (!r->has_qual) r->qual.clear();
    }
    return 1;
  }
};

// ---- BAM reader (bamlite.c:78-165 semantics) ----------------------------

// plausible-record predicate for the salvage resync scan — MUST match
// io/corruption.py record_plausible (the shared contract the
// differential fuzz tests pin)
inline bool record_plausible(const uint8_t* b, size_t avail,
                             int64_t max_rec) {
  if (avail < 36) return false;
  int32_t block_size, refid, pos, l_seq;
  uint16_t n_cigar;
  std::memcpy(&block_size, b, 4);
  if (block_size < kMinRecordBlock || block_size > max_rec) return false;
  std::memcpy(&refid, b + 4, 4);
  std::memcpy(&pos, b + 8, 4);
  if (!(refid == -1 || (refid >= 0 && refid < 100000)) || pos < -1)
    return false;
  uint8_t lrn = b[12];
  if (lrn < 2) return false;
  std::memcpy(&n_cigar, b + 16, 2);
  std::memcpy(&l_seq, b + 20, 4);
  if (l_seq < 0) return false;
  // 64-bit arithmetic: (l_seq + 1) on an attacker-controlled INT32_MAX
  // would be signed-overflow UB in 32 bits
  if (32 + (int64_t)lrn + 4 * (int64_t)n_cigar +
          ((int64_t)l_seq + 1) / 2 + (int64_t)l_seq > (int64_t)block_size)
    return false;
  if (avail < (size_t)36 + lrn) return false;
  if (b[36 + lrn - 1] != 0) return false;
  for (size_t i = 0; i + 1 < lrn; i++)
    if (b[36 + i] < 0x21 || b[36 + i] > 0x7E) return false;
  return true;
}

struct BamReader {
  GzStream s;
  bool header_done = false;
  std::vector<uint8_t> block;
  Salvage* sv = nullptr;

  // salvage feed: records are parsed out of `pend` so the scan can
  // look arbitrarily far ahead and a BGZF gap can be surfaced exactly
  // between the bytes on its two sides (io/bam.py _SalvageFeed mirror)
  std::string pend;
  size_t pos = 0;
  bool resync = false;

  bool salv() const { return sv != nullptr && sv->on; }

  // returns 0 ok, -3 bad header
  int read_header() {
    uint8_t magic[4];
    if (s.read(magic, 4) != 4 || std::memcmp(magic, "BAM\1", 4) != 0)
      return -3;
    int32_t l_text;
    if (s.read((uint8_t*)&l_text, 4) != 4 || l_text < 0 ||
        l_text > max_rec())
      return -3;
    std::vector<uint8_t> skip((size_t)l_text);
    if (s.read(skip.data(), l_text) != l_text) return -3;
    int32_t n_ref;
    if (s.read((uint8_t*)&n_ref, 4) != 4 || n_ref < 0 ||
        n_ref > 1 << 24)
      return -3;
    for (int32_t i = 0; i < n_ref; i++) {
      int32_t l_name;
      if (s.read((uint8_t*)&l_name, 4) != 4 || l_name < 1 ||
          l_name > 4096)
        return -3;
      skip.resize((size_t)l_name + 4);
      if (s.read(skip.data(), l_name + 4) != l_name + 4) return -3;
    }
    header_done = true;
    return 0;
  }

  // decode one alignment block at p (block_size bytes after the length
  // int) into r; false on inconsistent fields.  Shared by the fail-
  // fast and salvage paths so decode semantics can never diverge.
  bool decode_block(const uint8_t* p, int32_t block_size, Record* r) {
    uint8_t l_read_name = p[8];
    uint16_t n_cigar;
    int32_t l_seq;
    std::memcpy(&n_cigar, p + 12, 2);
    std::memcpy(&l_seq, p + 16, 4);
    if (l_read_name < 1) return false;  // io/bam.py decode_record parity
    if (l_seq < 0) return false;  // corrupt record; resize would throw
    int64_t off = 32;
    if (off + l_read_name > block_size) return false;
    r->name.assign((const char*)p + off,
                   l_read_name > 0 ? (size_t)(l_read_name - 1) : 0);
    off += l_read_name;
    off += 4 * (int64_t)n_cigar;
    // 64-bit: (l_seq + 1) at INT32_MAX would be signed-overflow UB
    int64_t nseq_bytes = ((int64_t)l_seq + 1) / 2;
    if (off + nseq_bytes + l_seq > block_size) return false;
    r->seq.resize((size_t)l_seq);
    for (int64_t i = 0; i < nseq_bytes; i++) {
      const uint8_t* two = kT.nib[p[off + i]];
      r->seq[(size_t)(2 * i)] = (char)two[0];
      if (2 * i + 1 < l_seq) r->seq[(size_t)(2 * i + 1)] = (char)two[1];
    }
    off += nseq_bytes;
    r->qual.resize((size_t)l_seq);
    for (int64_t i = 0; i < l_seq; i++) {
      int q = p[off + i] + 33;            // seqio.h:113
      r->qual[(size_t)i] = (char)(q > 126 ? 126 : q);
    }
    r->has_qual = true;
    return true;
  }

  const char* err_reason = nullptr;  // taxonomy code for a -3 here

  // the --max-record-bytes bound applies salvage ON OR OFF: the
  // Salvage struct is wired at open either way (sv->on gates only the
  // resync behavior)
  int64_t max_rec() const {
    return sv ? sv->max_record_bytes : kDefaultMaxRecordBytes;
  }

  // returns: 1 record, 0 clean EOF, -3 truncated/bad stream
  int next(Record* r) {
    if (salv()) return next_salvage(r);
    if (!header_done) {
      int rc = read_header();
      if (rc != 0) { err_reason = "bam_bad_header"; return rc; }
    }
    r->clear();
    int32_t block_size;
    int64_t got = s.read((uint8_t*)&block_size, 4);
    if (got == 0) return s.err ? -3 : 0;  // clean EOF (bamlite.c:141)
    if (got != 4 || block_size < 32 || block_size > max_rec()) {
      // the allocation bound: a corrupt int32 must be rejected BEFORE
      // block.resize() commits to it
      err_reason = (got == 4 && block_size > max_rec())
                       ? "bam_record_oversize" : "bam_bad_record";
      return -3;
    }
    block.resize((size_t)block_size);
    if (s.read(block.data(), block_size) != block_size) {
      err_reason = "bam_bad_record";
      return -3;
    }
    if (!decode_block(block.data(), block_size, r)) {
      err_reason = "bam_bad_record";
      return -3;
    }
    return 1;
  }

  // ---- salvage path (io/bam.py _read_bam_salvage mirror) ----------------

  // 0 ok, 1 gap (call take_gap), 2 eof
  int ensure(size_t n) {
    while (pend.size() - pos < n) {
      if (s.begin >= s.end) {
        if (!s.fill()) {
          if (s.gap_before) { s.gap_before = false; return 1; }
          return 2;
        }
        if (s.gap_before) { s.gap_before = false; return 1; }
      }
      pend.append((const char*)s.buf.data() + s.begin,
                  (size_t)(s.end - s.begin));
      s.begin = s.end;
    }
    return 0;
  }

  void take_gap() { pend.resize(pos); }

  void compact() {
    if (pos > (size_t)(1 << 16)) {
      pend.erase(0, pos);
      pos = 0;
    }
  }

  // 0 found, 2 eof (tail consumed)
  int scan_for_record() {
    int64_t max_rec = sv->max_record_bytes;
    for (;;) {
      int st = ensure((size_t)kScanLookahead);
      if (st == 1) { take_gap(); continue; }
      size_t avail = pend.size() - pos;
      if (st == 2 && avail < 36) { pos = pend.size(); return 2; }
      if (record_plausible((const uint8_t*)pend.data() + pos, avail,
                           max_rec))
        return 0;
      pos++;
      compact();
    }
  }

  // tolerant header parse over the feed; false = damaged (fall back
  // to the record scan).  Mirrors io/bam.py _salvage_header.
  bool salvage_header() {
    if (ensure(12) != 0 ||
        std::memcmp(pend.data() + pos, "BAM\1", 4) != 0)
      return false;
    int32_t l_text, n_ref;
    std::memcpy(&l_text, pend.data() + pos + 4, 4);
    if (l_text < 0 || l_text > kDefaultMaxRecordBytes) return false;
    if (ensure(12 + (size_t)l_text) != 0) return false;
    std::memcpy(&n_ref, pend.data() + pos + 8 + l_text, 4);
    if (n_ref < 0 || n_ref > 1 << 24) return false;
    pos += 12 + (size_t)l_text;
    for (int32_t i = 0; i < n_ref; i++) {
      if (ensure(4) != 0) return false;
      int32_t l_name;
      std::memcpy(&l_name, pend.data() + pos, 4);
      if (l_name < 1 || l_name > 4096) return false;
      if (ensure(8 + (size_t)l_name) != 0) return false;
      pos += 8 + (size_t)l_name;
    }
    return true;
  }

  int next_salvage(Record* r) {
    int64_t max_rec = sv->max_record_bytes;
    if (!header_done) {
      if (!salvage_header()) {
        sv->record("bam_bad_header");
        resync = true;
      }
      header_done = true;
    }
    r->clear();
    for (;;) {
      compact();
      if (resync) {
        if (scan_for_record() == 2) return 0;
        resync = false;
      }
      int st = ensure(4);
      if (st == 1) { take_gap(); resync = true; continue; }
      if (st == 2) {
        if (pend.size() - pos > 0) {
          sv->record("bam_bad_record");
          pos = pend.size();
        }
        return 0;
      }
      int32_t block_size;
      std::memcpy(&block_size, pend.data() + pos, 4);
      if (block_size < kMinRecordBlock || block_size > max_rec) {
        sv->record(block_size > max_rec ? "bam_record_oversize"
                                        : "bam_bad_record");
        pos++;
        resync = true;
        continue;
      }
      st = ensure(4 + (size_t)block_size);
      if (st == 1) { take_gap(); resync = true; continue; }
      if (st == 2) {
        sv->record("bam_bad_record");
        pos = pend.size();
        return 0;
      }
      if (!decode_block((const uint8_t*)pend.data() + pos + 4,
                        block_size, r)) {
        sv->record("bam_bad_record");
        pos++;
        resync = true;
        continue;
      }
      pos += 4 + (size_t)block_size;
      return 1;
    }
  }
};

// ---- ZMW group-by-hole streamer (seqio.h:152-201) ------------------------

struct Reader {
  bool is_bam = false;
  FastxReader fx;
  BamReader bam;
  std::string error;
  std::string reason;   // stable taxonomy code for `error` (corruption.py)
  Salvage salvage;      // salvage-mode switch + per-reason accounting

  // wire the shared Salvage into every layer (called at open; the
  // --max-record-bytes bound applies even with salvage OFF — sv->on
  // gates only the resync behavior)
  void wire_salvage() {
    fx.sv = &salvage;
    bam.sv = &salvage;
    (is_bam ? bam.s : fx.s).set_salvage(&salvage);
  }

  void set_max_record_bytes(int64_t max_record_bytes) {
    if (max_record_bytes > 0)
      salvage.max_record_bytes = max_record_bytes;
  }

  void enable_salvage(int64_t max_record_bytes) {
    salvage.on = true;
    set_max_record_bytes(max_record_bytes);
  }

  // filters (main.c:659-672); 0/absent = keep everything
  int32_t min_passes = 0;
  int64_t min_total = 0, max_total = 0;

  // filter accounting, bucketed by reason (the pure-Python path emits
  // per-hole zmw_filtered trace instants; the in-library filter here
  // was a blind spot — ccsx_filter_counts surfaces these so traced
  // native runs stop silently under-reporting filtering)
  int64_t filt_few_passes = 0, filt_short = 0, filt_long = 0;

  // lookahead carry (seqio.h:158-163)
  Record carry;
  bool have_carry = false;
  bool stream_done = false;

  // current hole output
  std::string movie, hole;
  std::string seqs;
  std::vector<int32_t> lens;

  // split "movie/hole/region"; returns false if not exactly 3 fields
  static bool split3(const std::string& name, std::string* m, std::string* h) {
    size_t a = name.find('/');
    if (a == std::string::npos) return false;
    size_t b = name.find('/', a + 1);
    if (b == std::string::npos) return false;
    if (name.find('/', b + 1) != std::string::npos) return false;
    m->assign(name, 0, a);
    h->assign(name, a + 1, b - a - 1);
    return true;
  }

  int next_record(Record* r) {
    return is_bam ? bam.next(r) : fx.next(r);
  }

  // taxonomy code for a -3 stream error in fail-fast mode: the
  // container layer's classification wins (it is causal), then the
  // record layer's, then the format's generic truncation code
  const char* stream_reason() {
    GzStream& s = is_bam ? bam.s : fx.s;
    if (s.err_reason) return s.err_reason;
    if (is_bam && bam.err_reason) return bam.err_reason;
    return is_bam ? "bam_bad_record" : "fastx_truncated";
  }

  bool keep() const {
    if (min_passes > 0 && (int32_t)lens.size() < min_passes) return false;
    int64_t total = (int64_t)seqs.size();
    if (max_total > 0 && total > max_total) return false;
    if (total < min_total) return false;
    return true;
  }

  // returns n_passes >= 0; -1 EOF; -2 invalid name; -3 stream error
  int next_zmw() {
    for (;;) {
      movie.clear(); hole.clear(); seqs.clear(); lens.clear();
      if (stream_done && !have_carry) return -1;
      if (have_carry) {
        if (!split3(carry.name, &movie, &hole)) {
          error = "invalid zmw name :" + carry.name;
          reason = "zmw_bad_name";
          return -2;
        }
        seqs.append(carry.seq);
        lens.push_back((int32_t)carry.seq.size());
        have_carry = false;
      }
      for (;;) {
        Record r;
        int rc = next_record(&r);
        if (rc == 0) { stream_done = true; break; }
        if (rc == -2) {
          error = "malformed FASTQ record: " + r.name;
          reason = "fastx_qual_mismatch";
          return -3;
        }
        if (rc < 0) {
          error = "truncated or corrupt input stream";
          if (reason.empty()) reason = stream_reason();
          return -3;
        }
        std::string m, h;
        if (!split3(r.name, &m, &h)) {
          if (salvage.on) {
            // salvage: the poisoned record is dropped and booked;
            // grouping re-anchors on the next record (io/zmw.py
            // group_zmws applies the same rule)
            salvage.record("zmw_bad_name");
            continue;
          }
          error = "invalid zmw name :" + r.name;
          reason = "zmw_bad_name";
          return -2;
        }
        if (lens.empty()) {
          movie.swap(m); hole.swap(h);
        } else if (m != movie || h != hole) {
          carry = std::move(r);
          have_carry = true;
          break;
        }
        seqs.append(r.seq);
        lens.push_back((int32_t)r.seq.size());
      }
      if (lens.empty()) return -1;
      if (keep()) return (int)lens.size();
      // filtered: count by reason (same precedence as keep()), then
      // loop to the next hole without crossing the API boundary
      if (min_passes > 0 && (int32_t)lens.size() < min_passes) {
        filt_few_passes++;
      } else if (max_total > 0 && (int64_t)seqs.size() > max_total) {
        filt_long++;
      } else {
        filt_short++;
      }
    }
  }
};

// ---- prefetching reader + ordered writer ---------------------------------
//
// The native equivalent of the reference's 3-step ordered pipeline
// (kt_pipeline, kthread.c:172-256; wired 2 threads x 3 steps at main.c:856):
// step 0 (read/group/filter) runs on a background thread here, step 1
// (consensus) runs in the caller, step 2 (write) on the writer thread
// below.  Chunk-order determinism is preserved because holes leave the
// queue in stream order and the caller feeds the writer in that order.

struct Hole {
  std::string movie, hole, seqs;
  std::vector<int32_t> lens;
};

struct Prefetcher {
  Reader reader;
  std::deque<Hole> queue;
  std::mutex mu;
  std::condition_variable cv_pop, cv_push;
  size_t cap = 64;
  int rc_final = 1;       // pending; set to <=-1 code when producer ends
  bool done = false;
  std::thread th;
  Hole current;           // last popped: owns buffers handed to the caller

  void run() {
    for (;;) {
      int rc = reader.next_zmw();
      std::unique_lock<std::mutex> lk(mu);
      if (rc < 0) { rc_final = rc; done = true; cv_pop.notify_all(); return; }
      cv_push.wait(lk, [&] { return queue.size() < cap || done; });
      if (done) return;  // closed under us
      Hole h;
      h.movie = reader.movie;
      h.hole = reader.hole;
      h.seqs.swap(reader.seqs);
      h.lens.swap(reader.lens);
      queue.push_back(std::move(h));
      cv_pop.notify_one();
    }
  }

  // same return codes as Reader::next_zmw
  int pop() {
    std::unique_lock<std::mutex> lk(mu);
    cv_pop.wait(lk, [&] { return !queue.empty() || done; });
    if (queue.empty()) return rc_final;
    current = std::move(queue.front());
    queue.pop_front();
    cv_push.notify_one();
    return (int)current.lens.size();
  }

  void close() {
    {
      std::lock_guard<std::mutex> lk(mu);
      done = true;
    }
    cv_push.notify_all();
    cv_pop.notify_all();
    if (th.joinable()) th.join();
  }
};

struct Writer {
  FILE* f = nullptr;
  bool own = false;
  std::deque<std::string> queue;
  std::mutex mu;
  std::condition_variable cv_pop, cv_push;
  size_t cap = 256;
  bool done = false, io_error = false;
  std::thread th;

  void run() {
    for (;;) {
      std::string item;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_pop.wait(lk, [&] { return !queue.empty() || done; });
        if (queue.empty()) break;
        item = std::move(queue.front());
        queue.pop_front();
        cv_push.notify_one();
      }
      if (!io_error &&
          fwrite(item.data(), 1, item.size(), f) != item.size()) {
        std::lock_guard<std::mutex> lk(mu);
        io_error = true;
      }
    }
  }

  bool put(std::string s) {
    std::unique_lock<std::mutex> lk(mu);
    if (io_error) return false;
    cv_push.wait(lk, [&] { return queue.size() < cap || done; });
    if (done) return false;
    queue.push_back(std::move(s));
    cv_pop.notify_one();
    return true;
  }

  // returns false on a prior write error
  bool close() {
    {
      std::lock_guard<std::mutex> lk(mu);
      done = true;
    }
    cv_pop.notify_all();
    cv_push.notify_all();
    if (th.joinable()) th.join();
    if (f) {
      if (fflush(f) != 0) io_error = true;
      if (own && fclose(f) != 0) io_error = true;
    }
    return !io_error;
  }
};

}  // namespace

// ---- C API ---------------------------------------------------------------

extern "C" {

void* ccsx_open(const char* path, int is_bam) {
  Reader* r = new Reader();
  r->is_bam = is_bam != 0;
  GzStream& s = r->is_bam ? r->bam.s : r->fx.s;
  if (!s.open(path)) { delete r; return nullptr; }
  r->wire_salvage();
  return r;
}

void ccsx_set_filter(void* h, int32_t min_passes, int64_t min_total,
                     int64_t max_total) {
  Reader* r = (Reader*)h;
  r->min_passes = min_passes;
  r->min_total = min_total;
  r->max_total = max_total;
}

// Salvage mode (--salvage): classified corruption is booked + resynced
// past instead of erroring the stream.  Must be called before the
// first next_* call.  max_record_bytes <= 0 keeps the default bound;
// with on == 0 only the bound is applied (fail-fast keeps its
// behavior, just with the caller's allocation limit).
void ccsx_set_salvage(void* h, int on, int64_t max_record_bytes) {
  Reader* r = (Reader*)h;
  r->set_max_record_bytes(max_record_bytes);
  if (on) r->enable_salvage(max_record_bytes);
}

// Fetch the next (filtered) hole. Returns n_passes>=0, -1 EOF, -2 invalid
// name, -3 stream error. Out pointers are valid until the next call.
int ccsx_next_zmw(void* h, const char** movie, const char** hole,
                  const uint8_t** seqs, int64_t* total_len,
                  const int32_t** lens, int32_t* n_passes) {
  Reader* r = (Reader*)h;
  int rc = r->next_zmw();
  if (rc >= 0) {
    *movie = r->movie.c_str();
    *hole = r->hole.c_str();
    *seqs = (const uint8_t*)r->seqs.data();
    *total_len = (int64_t)r->seqs.size();
    *lens = r->lens.data();
    *n_passes = (int32_t)r->lens.size();
  }
  return rc;
}

// Record-level access (no grouping). Returns 1 record, 0 EOF, -3 error.
// qual_len is -1 when the record carries no quality (FASTA).
int ccsx_next_record(void* h, const char** name, const char** comment,
                     const uint8_t** seq, int64_t* seq_len,
                     const uint8_t** qual, int64_t* qual_len) {
  Reader* r = (Reader*)h;
  r->carry.clear();
  int rc = r->next_record(&r->carry);
  if (rc == 1) {
    *name = r->carry.name.c_str();
    *comment = r->carry.comment.c_str();
    *seq = (const uint8_t*)r->carry.seq.data();
    *seq_len = (int64_t)r->carry.seq.size();
    *qual = (const uint8_t*)r->carry.qual.data();
    *qual_len = r->carry.has_qual ? (int64_t)r->carry.qual.size() : -1;
  } else if (rc == -2) {
    r->error = "malformed FASTQ record: " + r->carry.name;
    r->reason = "fastx_qual_mismatch";
    rc = -3;
  } else if (rc < 0) {
    if (r->error.empty()) r->error = "truncated or invalid stream";
    if (r->reason.empty()) r->reason = r->stream_reason();
    rc = -3;
  }
  return rc;
}

const char* ccsx_error(void* h) { return ((Reader*)h)->error.c_str(); }

// Stable taxonomy code (io/corruption.py REASONS) for the last error
// reported by this handle; empty when none.
const char* ccsx_error_reason(void* h) {
  return ((Reader*)h)->reason.c_str();
}

// Salvage accounting: total classified corruption events (live-safe —
// atomic), and the per-reason summary "reason:count,..." (call only
// after EOF; the buffer is owned by the handle).
int64_t ccsx_corrupt_events(void* h) {
  return ((Reader*)h)->salvage.events.load(std::memory_order_relaxed);
}

int64_t ccsx_corrupt_exempt(void* h) {
  return ((Reader*)h)->salvage.exempt.load(std::memory_order_relaxed);
}

const char* ccsx_corrupt_summary(void* h) {
  return ((Reader*)h)->salvage.build_summary();
}

// Filter accounting (reason-bucketed counts of holes the in-library
// filters dropped).  Valid at any point; complete once next_zmw
// returned EOF.
void ccsx_filter_counts(void* h, int64_t* few_passes, int64_t* too_short,
                        int64_t* too_long) {
  Reader* r = (Reader*)h;
  *few_passes = r->filt_few_passes;
  *too_short = r->filt_short;
  *too_long = r->filt_long;
}

void ccsx_close(void* h) {
  Reader* r = (Reader*)h;
  GzStream& s = r->is_bam ? r->bam.s : r->fx.s;
  s.close();
  delete r;
}

// ---- prefetching reader (background read step) ---------------------------

void* ccsx_prefetch_open(const char* path, int is_bam, int32_t min_passes,
                         int64_t min_total, int64_t max_total,
                         int32_t queue_cap) {
  Prefetcher* p = new Prefetcher();
  p->reader.is_bam = is_bam != 0;
  GzStream& s = p->reader.is_bam ? p->reader.bam.s : p->reader.fx.s;
  if (!s.open(path)) { delete p; return nullptr; }
  p->reader.wire_salvage();
  p->reader.min_passes = min_passes;
  p->reader.min_total = min_total;
  p->reader.max_total = max_total;
  if (queue_cap > 0) p->cap = (size_t)queue_cap;
  p->th = std::thread([p] { p->run(); });
  return p;
}

// Salvage-capable prefetch open: salvage must be fixed before the
// producer thread starts, hence a distinct entry point rather than a
// set_* call (the plain open keeps its historical signature).
void* ccsx_prefetch_open_s(const char* path, int is_bam,
                           int32_t min_passes, int64_t min_total,
                           int64_t max_total, int32_t queue_cap,
                           int salvage, int64_t max_record_bytes) {
  Prefetcher* p = new Prefetcher();
  p->reader.is_bam = is_bam != 0;
  GzStream& s = p->reader.is_bam ? p->reader.bam.s : p->reader.fx.s;
  if (!s.open(path)) { delete p; return nullptr; }
  p->reader.wire_salvage();
  p->reader.set_max_record_bytes(max_record_bytes);
  if (salvage) p->reader.enable_salvage(max_record_bytes);
  p->reader.min_passes = min_passes;
  p->reader.min_total = min_total;
  p->reader.max_total = max_total;
  if (queue_cap > 0) p->cap = (size_t)queue_cap;
  p->th = std::thread([p] { p->run(); });
  return p;
}

int ccsx_prefetch_next(void* h, const char** movie, const char** hole,
                       const uint8_t** seqs, int64_t* total_len,
                       const int32_t** lens, int32_t* n_passes) {
  Prefetcher* p = (Prefetcher*)h;
  int rc = p->pop();
  if (rc >= 0) {
    *movie = p->current.movie.c_str();
    *hole = p->current.hole.c_str();
    *seqs = (const uint8_t*)p->current.seqs.data();
    *total_len = (int64_t)p->current.seqs.size();
    *lens = p->current.lens.data();
    *n_passes = (int32_t)p->current.lens.size();
  }
  return rc;
}

const char* ccsx_prefetch_error(void* h) {
  return ((Prefetcher*)h)->reader.error.c_str();
}

const char* ccsx_prefetch_error_reason(void* h) {
  return ((Prefetcher*)h)->reader.reason.c_str();
}

// Live classified-corruption event count (atomic: the producer thread
// books while the consumer polls).
int64_t ccsx_prefetch_corrupt_events(void* h) {
  return ((Prefetcher*)h)
      ->reader.salvage.events.load(std::memory_order_relaxed);
}

int64_t ccsx_prefetch_corrupt_exempt(void* h) {
  return ((Prefetcher*)h)
      ->reader.salvage.exempt.load(std::memory_order_relaxed);
}

// Per-reason summary; call after EOF (pop() returned rc_final) — the
// queue-mutex handoff orders the producer's final writes before this.
const char* ccsx_prefetch_corrupt_summary(void* h) {
  Prefetcher* p = (Prefetcher*)h;
  std::lock_guard<std::mutex> lk(p->mu);
  return p->reader.salvage.build_summary();
}

// Same accounting for the prefetching streamer.  The counters are
// written by the producer thread; the consumer calls this after EOF
// (pop() returned rc_final), whose queue-mutex handoff orders the
// producer's final writes before this read.
void ccsx_prefetch_filter_counts(void* h, int64_t* few_passes,
                                 int64_t* too_short, int64_t* too_long) {
  Prefetcher* p = (Prefetcher*)h;
  std::lock_guard<std::mutex> lk(p->mu);
  *few_passes = p->reader.filt_few_passes;
  *too_short = p->reader.filt_short;
  *too_long = p->reader.filt_long;
}

void ccsx_prefetch_close(void* h) {
  Prefetcher* p = (Prefetcher*)h;
  p->close();
  GzStream& s = p->reader.is_bam ? p->reader.bam.s : p->reader.fx.s;
  s.close();
  delete p;
}

// ---- ordered async writer (background write step) ------------------------

void* ccsx_writer_open(const char* path, int append) {
  Writer* w = new Writer();
  if (std::strcmp(path, "-") == 0) {
    w->f = stdout;
  } else {
    w->f = fopen(path, append ? "a" : "w");
    w->own = true;
  }
  if (!w->f) { delete w; return nullptr; }
  w->th = std::thread([w] { w->run(); });
  return w;
}

// append one FASTA record (">name\nseq\n"); returns 0 ok, -1 on io error
int ccsx_writer_put_fasta(void* h, const char* name, const uint8_t* seq,
                          int64_t len) {
  Writer* w = (Writer*)h;
  std::string s;
  s.reserve((size_t)len + std::strlen(name) + 3);
  s.push_back('>');
  s.append(name);
  s.push_back('\n');
  s.append((const char*)seq, (size_t)len);
  s.push_back('\n');
  return w->put(std::move(s)) ? 0 : -1;
}

// FASTQ record: @name / seq / + / qual (qual = phred+33 ASCII, len bytes)
int ccsx_writer_put_fastq(void* h, const char* name, const uint8_t* seq,
                          const uint8_t* qual, int64_t len) {
  Writer* w = (Writer*)h;
  std::string s;
  s.reserve(2 * (size_t)len + std::strlen(name) + 6);
  s.push_back('@');
  s.append(name);
  s.push_back('\n');
  s.append((const char*)seq, (size_t)len);
  s.append("\n+\n", 3);
  s.append((const char*)qual, (size_t)len);
  s.push_back('\n');
  return w->put(std::move(s)) ? 0 : -1;
}

// returns 0 ok, -1 if any write failed
int ccsx_writer_close(void* h) {
  Writer* w = (Writer*)h;
  bool ok = w->close();
  delete w;
  return ok ? 0 : -1;
}

// ---- BGZF pool bench (decoupled from the reader) -------------------------

// Pre-reads every compressed block of a BGZF file into memory, then times
// `threads` workers inflating the whole set with atomic work-claiming (the
// same claim discipline as the reference's kt_for, kthread.c:39) — no file
// IO, no record parse, no ordered hand-off.  This isolates the inflate
// pool's scaling from everything BgzfMT::next_block interleaves with it,
// so the curve measures the pool, not the reader (SURVEY §7.3 item 6).
// Returns best-of-`iters` uncompressed MB/s, or -1 on a malformed file.
double ccsx_bgzf_pool_bench(const char* path, int threads, int iters) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1.0;
  BgzfMT rd;
  rd.f = f;
  std::vector<std::shared_ptr<BgzfMT::Job>> jobs;
  uint64_t total = 0;
  while (auto j = rd.read_raw()) {
    total += j->isize;
    jobs.push_back(std::move(j));
  }
  bool bad = rd.err;
  fclose(f);
  rd.f = nullptr;
  if (bad || jobs.empty() || total == 0) return -1.0;
  if (threads < 1) threads = 1;
  if (iters < 1) iters = 1;
  double best = 0.0;
  for (int it = 0; it < iters; it++) {
    std::atomic<size_t> next{0};
    std::atomic<bool> ok{true};
    auto run = [&] {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= jobs.size()) return;
        if (!BgzfMT::inflate_job(jobs[i].get())) ok = false;
      }
    };
    auto t0 = std::chrono::steady_clock::now();
    std::vector<std::thread> ws;
    for (int t = 1; t < threads; t++) ws.emplace_back(run);
    run();
    for (auto& t : ws) t.join();
    double dt = std::chrono::duration<double>(
                    std::chrono::steady_clock::now() - t0)
                    .count();
    if (!ok.load()) return -1.0;
    if (dt > 0) best = std::max(best, total / dt / (1 << 20));
  }
  return best;
}

// ---- encode / reverse-complement (main.c:222-241, seqio.h:120-148) ------

void ccsx_encode(const uint8_t* ascii, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = kT.enc[ascii[i]];
}

void ccsx_revcomp_ascii(const uint8_t* in, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) out[i] = kT.comp[in[n - 1 - i]];
}

void ccsx_revcomp_codes(const uint8_t* in, int64_t n, uint8_t* out) {
  for (int64_t i = 0; i < n; i++) {
    uint8_t c = in[n - 1 - i];
    out[i] = c < 4 ? (uint8_t)(3 - c) : c;
  }
}

}  // extern "C"
