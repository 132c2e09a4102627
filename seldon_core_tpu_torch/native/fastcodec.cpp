// fastcodec: native wire-codec hot path for the serving runtime.
//
// Role in the framework: the reference's "native tier" is its Java engine —
// every request body is JSON-parsed and re-serialized on the hot path
// (engine/.../InternalPredictionService.java form-encoded json= hops). Our
// engine keeps the graph in-process, so the remaining CPU cost of a REST
// prediction is exactly (a) parsing the request's number matrix and
// (b) serializing the response's number matrix. Both are implemented here in
// C++ and bound via ctypes (native/__init__.py), with a pure-Python fallback
// when no compiler is available.
//
// Contract (all functions return 0 on success, negative error codes below):
//   ndarray_find   locate the value span of the first "ndarray" key
//   ndarray_probe  shape-check a rectangular 2D numeric JSON array
//   ndarray_parse  parse it into a caller-allocated float32 buffer
//   ndarray_encode serialize a float32 matrix to JSON into a caller buffer
//   pad_rows_f32   copy rows into a zero-padded bucket buffer
//
// Build: g++ -O3 -shared -fPIC (native/__init__.py compiles lazily and
// caches the .so next to this file).

#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

enum {
  OK = 0,
  ERR_NOT_FOUND = -1,   // no "ndarray" key
  ERR_SYNTAX = -2,      // malformed JSON in the array span
  ERR_NOT_RECT = -3,    // ragged rows
  ERR_NOT_NUMERIC = -4, // strings/objects inside the array
  ERR_TOO_DEEP = -5,    // not a 1D/2D array
  ERR_BOUNDS = -6,      // caller buffer too small
};

static const char *skip_ws(const char *p, const char *end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
    ++p;
  return p;
}

// Find the first occurrence of the JSON key "ndarray" (outside of string
// values we can cheaply ignore: we scan for the quoted key then a colon) and
// return the [start, end) byte span of its value.
int ndarray_find(const char *buf, long len, long *start, long *end) {
  static const char key[] = "\"ndarray\"";
  const char *bufend = buf + len;
  const char *p = buf;
  bool in_str = false;
  while (p < bufend) {
    if (in_str) {
      if (*p == '\\' && p + 1 < bufend)
        ++p;
      else if (*p == '"')
        in_str = false;
      ++p;
      continue;
    }
    if (*p == '"') {
      if ((long)(bufend - p) >= (long)sizeof(key) - 1 &&
          memcmp(p, key, sizeof(key) - 1) == 0) {
        const char *q = skip_ws(p + sizeof(key) - 1, bufend);
        if (q < bufend && *q == ':') {
          q = skip_ws(q + 1, bufend);
          if (q >= bufend || *q != '[')
            return ERR_SYNTAX;
          // scan to the matching bracket (strings inside are rejected later
          // by probe, but skip them correctly here)
          long depth = 0;
          bool s = false;
          const char *r = q;
          while (r < bufend) {
            char c = *r;
            if (s) {
              if (c == '\\' && r + 1 < bufend)
                ++r;
              else if (c == '"')
                s = false;
            } else if (c == '"') {
              s = true;
            } else if (c == '[') {
              ++depth;
            } else if (c == ']') {
              if (--depth == 0) {
                *start = (long)(q - buf);
                *end = (long)(r - buf) + 1;
                return OK;
              }
            }
            ++r;
          }
          return ERR_SYNTAX;
        }
      }
      in_str = true;
      ++p;
      continue;
    }
    ++p;
  }
  return ERR_NOT_FOUND;
}

// Parse one number with strtod; returns nullptr on failure.
static const char *parse_num(const char *p, const char *end, double *out) {
  char *q;
  *out = strtod(p, &q);
  if (q == p || q > end)
    return nullptr;
  return q;
}

// Structural scan of one number: strict JSON number grammar
// ('-'? digits ('.' digits)? ([eE][+-]? digits)?) so the fast path accepts
// exactly what the Python oracle accepts — no strtod needed here, the parse
// pass re-reads the value. Returns nullptr on grammar violation.
static const char *scan_num(const char *p, const char *end) {
  const char *q = p;
  if (q < end && *q == '-')
    ++q;
  const char *int_start = q;
  while (q < end && *q >= '0' && *q <= '9')
    ++q;
  if (q == int_start)
    return nullptr; // no integer part ('.5', '+1', '-' alone all invalid)
  if (q < end && *q == '.') {
    ++q;
    const char *frac_start = q;
    while (q < end && *q >= '0' && *q <= '9')
      ++q;
    if (q == frac_start)
      return nullptr; // trailing dot ('5.')
  }
  if (q < end && (*q == 'e' || *q == 'E')) {
    ++q;
    if (q < end && (*q == '+' || *q == '-'))
      ++q;
    const char *exp_start = q;
    while (q < end && *q >= '0' && *q <= '9')
      ++q;
    if (q == exp_start)
      return nullptr;
  }
  return q;
}

// Probe a 1D or 2D numeric array: shape check + syntax check in one pass.
// 1D arrays report rows=1, cols=n, is2d=0.
int ndarray_probe(const char *buf, long len, long *rows, long *cols,
                  int *is2d) {
  const char *end = buf + len;
  const char *p = skip_ws(buf, end);
  if (p >= end || *p != '[')
    return ERR_SYNTAX;
  p = skip_ws(p + 1, end);
  if (p < end && *p == ']') { // empty array
    *rows = 0;
    *cols = 0;
    *is2d = 0;
    return OK;
  }
  if (p < end && *p == '[') {
    // 2D
    long r = 0, c_first = -1;
    while (true) {
      if (p >= end || *p != '[')
        return ERR_SYNTAX;
      p = skip_ws(p + 1, end);
      long c = 0;
      if (p < end && *p != ']') {
        while (true) {
          const char *q = scan_num(p, end);
          if (!q)
            return ERR_NOT_NUMERIC;
          ++c;
          p = skip_ws(q, end);
          if (p < end && *p == ',') {
            p = skip_ws(p + 1, end);
            continue;
          }
          break;
        }
      }
      if (p >= end || *p != ']')
        return ERR_SYNTAX;
      ++r;
      if (c_first < 0)
        c_first = c;
      else if (c != c_first)
        return ERR_NOT_RECT;
      p = skip_ws(p + 1, end);
      if (p < end && *p == ',') {
        p = skip_ws(p + 1, end);
        if (p < end && *p == '[')
          continue;
        return ERR_TOO_DEEP; // mixed 2D and scalar elements
      }
      break;
    }
    if (p >= end || *p != ']')
      return ERR_SYNTAX;
    *rows = r;
    *cols = c_first < 0 ? 0 : c_first;
    *is2d = 1;
    return OK;
  }
  // 1D
  long c = 0;
  while (true) {
    const char *q = scan_num(p, end);
    if (!q)
      return ERR_NOT_NUMERIC;
    ++c;
    p = skip_ws(q, end);
    if (p < end && *p == ',') {
      p = skip_ws(p + 1, end);
      continue;
    }
    break;
  }
  if (p >= end || *p != ']')
    return ERR_SYNTAX;
  *rows = 1;
  *cols = c;
  *is2d = 0;
  return OK;
}

// Fill a pre-allocated float32 buffer of rows*cols (caller ran probe).
int ndarray_parse(const char *buf, long len, float *out, long rows,
                  long cols) {
  const char *end = buf + len;
  const char *p = buf;
  long need = rows * cols, got = 0;
  while (p < end && got < need) {
    char ch = *p;
    if ((ch >= '0' && ch <= '9') || ch == '-') {
      // re-validate the token grammar (probe ran scan_num over the same
      // text, but defense-in-depth keeps the two passes agreeing), then
      // convert with strtod and require a structural terminator so
      // '1-2' / '1.2.3' can never silently parse as one number
      const char *tok_end = scan_num(p, end);
      if (!tok_end)
        return ERR_NOT_NUMERIC;
      double v;
      const char *q = parse_num(p, end, &v);
      if (!q || q != tok_end)
        return ERR_NOT_NUMERIC;
      if (q < end) {
        char t = *q;
        if (!(t == ',' || t == ']' || t == ' ' || t == '\t' || t == '\n' ||
              t == '\r'))
          return ERR_NOT_NUMERIC;
      }
      out[got++] = (float)v;
      p = q;
    } else {
      ++p;
    }
  }
  return got == need ? OK : ERR_SYNTAX;
}

// Serialize a float32 matrix as a 2D JSON array into dst (cap bytes incl.
// NUL). Returns bytes written (excl. NUL) or a negative error.
long ndarray_encode(const float *src, long rows, long cols, char *dst,
                    long cap) {
  long w = 0;
#define PUT(c)                                                                 \
  do {                                                                         \
    if (w + 1 >= cap)                                                          \
      return ERR_BOUNDS;                                                       \
    dst[w++] = (c);                                                            \
  } while (0)
  PUT('[');
  for (long r = 0; r < rows; ++r) {
    if (r)
      PUT(',');
    PUT('[');
    for (long c = 0; c < cols; ++c) {
      if (c)
        PUT(',');
      if (w + 32 >= cap)
        return ERR_BOUNDS;
      // %.9g round-trips float32 exactly
      int n = snprintf(dst + w, (size_t)(cap - w), "%.9g",
                       (double)src[r * cols + c]);
      if (n < 0)
        return ERR_SYNTAX;
      w += n;
    }
    PUT(']');
  }
  PUT(']');
  dst[w] = '\0';
  return w;
#undef PUT
}

// Copy n rows of feat floats into a bucket x feat buffer, zeroing the tail.
int pad_rows_f32(const float *src, long n, long feat, long bucket,
                 float *dst) {
  if (n > bucket)
    return ERR_BOUNDS;
  memcpy(dst, src, (size_t)(n * feat) * sizeof(float));
  memset(dst + n * feat, 0, (size_t)((bucket - n) * feat) * sizeof(float));
  return OK;
}

} // extern "C"

// ---------------------------------------------------------------------------
// HTTP/1.1 request-head parser — the fast ingress's hot-path front half
// (serving/fast_http.py). One pass over the buffer extracts everything the
// data plane needs: method/path spans, Content-Length, the raw Content-Type
// and Authorization values, and connection flags. Python keeps the full
// header-dict parse as the fallback/semantic reference.

extern "C" {

enum {
  HTTP_INCOMPLETE = 0,   // no \r\n\r\n yet — read more
  HTTP_MALFORMED = -1,
};

enum {
  HDRF_HAS_CTYPE = 1,
  HDRF_CONN_CLOSE = 2,
  HDRF_HAS_TE = 4,
  HDRF_HAS_CLEN = 8,
};

// RFC 7230 3.2.6 token charset for header field-names. Names containing
// anything else (form-feed, vertical tab, NBSP, NUL...) are rejected
// outright — lenient proxies normalize some of these, re-opening the
// hidden-Transfer-Encoding smuggling family if we merely mis-file them.
static int is_tchar(unsigned char c) {
  if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || (c >= '0' && c <= '9'))
    return 1;
  switch (c) {
    case '!': case '#': case '$': case '%': case '&': case '\'': case '*':
    case '+': case '-': case '.': case '^': case '_': case '`': case '|':
    case '~':
      return 1;
  }
  return 0;
}

static int ieq_n(const unsigned char *a, long n, const char *lit) {
  for (long i = 0; i < n; i++) {
    if (lit[i] == '\0') return 0;  // name longer than lit (embedded NUL safe)
    unsigned char c = a[i];
    if (c >= 'A' && c <= 'Z') c += 32;
    if (c != (unsigned char)lit[i]) return 0;
  }
  return lit[n] == '\0';
}

// Returns the body-start offset (> 0), HTTP_INCOMPLETE, or HTTP_MALFORMED.
// method/path are returned as (offset, length) into buf; header values are
// copied verbatim (caller buffers; value truncated to cap, reported length
// is the TRUNCATED length — caps are sized far above legal values).
long http_parse_head(const unsigned char *buf, long n,
                     long *method_len,
                     long *path_off, long *path_len,
                     long long *content_length, long *flags,
                     unsigned char *ctype_buf, long ctype_cap, long *ctype_len,
                     unsigned char *auth_buf, long auth_cap, long *auth_len) {
  *flags = 0;
  *content_length = -1;
  *ctype_len = -1;
  *auth_len = -1;
  // find end of head
  long head_end = -1;
  for (long i = 0; i + 3 < n; i++) {
    if (buf[i] == '\r' && buf[i + 1] == '\n' && buf[i + 2] == '\r' &&
        buf[i + 3] == '\n') {
      head_end = i;
      break;
    }
  }
  if (head_end < 0) return HTTP_INCOMPLETE;

  // strict line discipline over the whole head: every '\n' must be part of
  // a CRLF and every '\r' must start one. A bare LF accepted as a line
  // break by a tolerant front proxy (RFC 7230 3.5) would hide a
  // Transfer-Encoding header inside what we'd treat as a header VALUE —
  // the TE.CL smuggling family again, via framing disagreement
  for (long i = 0; i < head_end; i++) {
    if (buf[i] == '\n' && (i == 0 || buf[i - 1] != '\r')) return HTTP_MALFORMED;
    if (buf[i] == '\r' && buf[i + 1] != '\n') return HTTP_MALFORMED;
  }

  // request line: METHOD SP PATH SP VERSION
  long p = 0;
  while (p < head_end && buf[p] != ' ') p++;
  if (p == 0 || p >= head_end) return HTTP_MALFORMED;
  *method_len = p;
  long ps = p + 1;
  long pe = ps;
  // bound the path scan at the request line's own end: without this, a
  // request line missing the HTTP version would swallow header bytes
  while (pe < head_end && buf[pe] != ' ' && buf[pe] != '\r') pe++;
  if (pe == ps || pe >= head_end || buf[pe] != ' ') return HTTP_MALFORMED;
  *path_off = ps;
  *path_len = pe - ps;
  // skip to end of request line
  long line = pe;
  while (line + 1 < head_end && !(buf[line] == '\r' && buf[line + 1] == '\n'))
    line++;
  long pos = line + 2;  // first header line (or == head_end + something)

  while (pos < head_end) {
    long eol = pos;
    while (eol + 1 <= head_end && !(buf[eol] == '\r' && buf[eol + 1] == '\n'))
      eol++;
    // leading whitespace = obs-fold line continuation (RFC 7230 3.2.4):
    // reject rather than guess — a proxy that trims it would file
    // " Transfer-Encoding: chunked" under TE while we'd skip it
    if (buf[pos] == ' ' || buf[pos] == '\t') return HTTP_MALFORMED;
    // header: NAME ':' OWS VALUE
    long colon = pos;
    while (colon < eol && buf[colon] != ':') colon++;
    if (colon < eol) {
      long name_len = colon - pos;
      // RFC 7230 3.2.4/3.2.6: the field-name must be pure token chars —
      // rejects "Transfer-Encoding : chunked" (space before colon) and
      // form-feed/NBSP variants alike; empty names are malformed too
      if (name_len == 0) return HTTP_MALFORMED;
      for (long i = pos; i < colon; i++)
        if (!is_tchar(buf[i])) return HTTP_MALFORMED;
      long vs = colon + 1;
      while (vs < eol && (buf[vs] == ' ' || buf[vs] == '\t')) vs++;
      long ve = eol;
      while (ve > vs && (buf[ve - 1] == ' ' || buf[ve - 1] == '\t')) ve--;
      const unsigned char *name = buf + pos;
      if (ieq_n(name, name_len, "content-length")) {
        long long v = 0;
        int any = 0;
        for (long i = vs; i < ve; i++) {
          if (buf[i] < '0' || buf[i] > '9') return HTTP_MALFORMED;
          if (v > (1LL << 53)) return HTTP_MALFORMED;  // overflow guard:
          // a 20-digit length would wrap signed 64-bit (UB) and smuggle
          // body bytes into the next pipelined request
          v = v * 10 + (buf[i] - '0');
          any = 1;
        }
        if (!any) return HTTP_MALFORMED;
        // RFC 7230 3.3.2: multiple differing Content-Length values MUST be
        // rejected (CL.CL desync); equal duplicates are tolerated
        if ((*flags & HDRF_HAS_CLEN) && *content_length != v)
          return HTTP_MALFORMED;
        *content_length = v;
        *flags |= HDRF_HAS_CLEN;
      } else if (ieq_n(name, name_len, "content-type")) {
        *flags |= HDRF_HAS_CTYPE;
        long len = ve - vs;
        if (len > ctype_cap) len = ctype_cap;
        memcpy(ctype_buf, buf + vs, (size_t)len);
        *ctype_len = len;
      } else if (ieq_n(name, name_len, "authorization")) {
        long len = ve - vs;
        if (len > auth_cap) len = auth_cap;
        memcpy(auth_buf, buf + vs, (size_t)len);
        *auth_len = len;
      } else if (ieq_n(name, name_len, "connection")) {
        if (ve - vs == 5 && ieq_n(buf + vs, 5, "close")) *flags |= HDRF_CONN_CLOSE;
      } else if (ieq_n(name, name_len, "transfer-encoding")) {
        // ANY Transfer-Encoding (chunked, "gzip, chunked", unknown codings)
        // is outside this server's contract; flag on presence so the caller
        // rejects instead of framing by Content-Length (TE.CL smuggling)
        *flags |= HDRF_HAS_TE;
      }
    }
    pos = eol + 2;
  }
  return head_end + 4;
}

} // extern "C"
