/* fqz5c: millisecond CLI client for the fqz5 daemon.
 *
 * The reference binary's main() is live in ~2ms (fqzcomp5.c:4742); a
 * python-hosted CLI pays ~50ms of interpreter+import boot per
 * invocation even with the pre-warmed daemon doing the real work
 * (round 5 measurement: python -S 12ms + socket/json/package imports
 * ~25ms + 8ms daemon round trip).  This client speaks the daemon's
 * unix-socket protocol directly (daemon.py: one JSON request line +
 * SCM_RIGHTS fds 0/1/2, one JSON reply line), cutting the fixed cost
 * to ~1ms + the round trip.  Anything it cannot serve — no daemon
 * running, stale reply, control verbs, opt-outs — falls back to
 * exec'ing the python launcher (bin/_fqz5_main.py), which also owns
 * the auto-spawn-after-job behaviour.
 *
 * Built by native/Makefile into bin/fqz5c; bin/fqz5 (sh) execs it
 * when present.
 */
#define _GNU_SOURCE
#include <errno.h>
#include <limits.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <sys/un.h>
#include <unistd.h>

extern char **environ;

/* ---- growable byte buffer -------------------------------------- */
typedef struct { char *p; size_t n, cap; } buf_t;

static void buf_put(buf_t *b, const char *s, size_t n) {
    if (b->n + n + 1 > b->cap) {
        b->cap = (b->cap ? b->cap * 2 : 4096);
        while (b->cap < b->n + n + 1) b->cap *= 2;
        b->p = realloc(b->p, b->cap);
        if (!b->p) _exit(112);
    }
    memcpy(b->p + b->n, s, n);
    b->n += n;
    b->p[b->n] = 0;
}

static void buf_str(buf_t *b, const char *s) { buf_put(b, s, strlen(s)); }

/* JSON string literal (escapes ", \, control bytes; UTF-8 passes). */
static void buf_json(buf_t *b, const char *s) {
    buf_put(b, "\"", 1);
    for (const unsigned char *c = (const unsigned char *)s; *c; c++) {
        if (*c == '"' || *c == '\\') {
            char e[3] = {'\\', (char)*c, 0};
            buf_put(b, e, 2);
        } else if (*c < 0x20) {
            char e[8];
            snprintf(e, sizeof e, "\\u%04x", *c);
            buf_put(b, e, 6);
        } else {
            buf_put(b, (const char *)c, 1);
        }
    }
    buf_put(b, "\"", 1);
}

/* ---- python-launcher fallback ---------------------------------- */
static void fallback(int argc, char **argv) {
    (void)argc;
    char self[PATH_MAX];
    ssize_t n = readlink("/proc/self/exe", self, sizeof self - 1);
    if (n <= 0) { perror("fqz5c: readlink"); _exit(111); }
    self[n] = 0;
    char *slash = strrchr(self, '/');
    if (slash) *slash = 0;
    static char main_py[PATH_MAX + 32];
    snprintf(main_py, sizeof main_py, "%s/_fqz5_main.py", self);
    /* .pyc caching matters for the fallback's cold start */
    unsetenv("PYTHONDONTWRITEBYTECODE");
    int i, nargs = 0;
    while (argv[nargs]) nargs++;
    char **nv = calloc((size_t)nargs + 4, sizeof(char *));
    if (!nv) _exit(112);
    nv[0] = "python3";
    nv[1] = main_py;
    for (i = 1; i < nargs; i++) nv[i + 1] = argv[i];
    execvp("python3", nv);
    perror("fqz5c: exec python3");
    _exit(111);
}

int main(int argc, char **argv) {
    const char *dmn = getenv("FQZ5_DAEMON");
    const char *nod = getenv("FQZ5_NO_DAEMON");
    if ((nod && *nod) || (dmn && !strcmp(dmn, "0")))
        fallback(argc, argv);
    for (int i = 1; i < argc; i++)
        if (!strcmp(argv[i], "--daemon") || !strcmp(argv[i], "--daemon-stop"))
            fallback(argc, argv);  /* control verbs: python handles */

    char sock_path[PATH_MAX];
    if (dmn && *dmn && strcmp(dmn, "1") && strcmp(dmn, "auto")) {
        snprintf(sock_path, sizeof sock_path, "%s", dmn);
    } else {
        const char *tmp = getenv("TMPDIR");
        snprintf(sock_path, sizeof sock_path, "%s/fqz5-daemon-%ld.sock",
                 (tmp && *tmp) ? tmp : "/tmp", (long)getuid());
    }

    int fd = socket(AF_UNIX, SOCK_STREAM, 0);
    if (fd < 0) fallback(argc, argv);
    struct sockaddr_un sa;
    memset(&sa, 0, sizeof sa);
    sa.sun_family = AF_UNIX;
    if (strlen(sock_path) >= sizeof sa.sun_path) fallback(argc, argv);
    strcpy(sa.sun_path, sock_path);
    if (connect(fd, (struct sockaddr *)&sa, sizeof sa) != 0) {
        close(fd);
        fallback(argc, argv);
    }

    /* request line: {"argv": [...], "cwd": "...", "umask": n,
     *                "env": {FQZ5_ vars + TMPDIR, no FQZ5_DAEMON}} */
    buf_t b = {0};
    buf_str(&b, "{\"argv\": [");
    for (int i = 1; i < argc; i++) {
        if (i > 1) buf_str(&b, ", ");
        buf_json(&b, argv[i]);
    }
    buf_str(&b, "], \"cwd\": ");
    char cwd[PATH_MAX];
    if (!getcwd(cwd, sizeof cwd)) cwd[0] = 0;
    buf_json(&b, cwd);
    mode_t um = umask(0);
    umask(um);
    char tmpnum[32];
    snprintf(tmpnum, sizeof tmpnum, ", \"umask\": %d, \"env\": {",
             (int)um);
    buf_str(&b, tmpnum);
    int first = 1;
    for (char **e = environ; *e; e++) {
        const char *eq = strchr(*e, '=');
        if (!eq) continue;
        size_t kl = (size_t)(eq - *e);
        if (!((kl > 5 && !strncmp(*e, "FQZ5_", 5)) ||
              (kl == 6 && !strncmp(*e, "TMPDIR", 6))))
            continue;
        if (kl == 11 && !strncmp(*e, "FQZ5_DAEMON", 11))
            continue;  /* child must not recurse */
        char key[256];
        if (kl >= sizeof key) continue;
        memcpy(key, *e, kl);
        key[kl] = 0;
        if (!first) buf_str(&b, ", ");
        first = 0;
        buf_json(&b, key);
        buf_str(&b, ": ");
        buf_json(&b, eq + 1);
    }
    buf_str(&b, "}}\n");

    /* sendmsg: request + fds 0,1,2 via SCM_RIGHTS (daemon dup2s them
     * so pipes/ttys/redirections behave exactly as a direct run) */
    struct iovec iov = {b.p, b.n};
    char cbuf[CMSG_SPACE(3 * sizeof(int))];
    memset(cbuf, 0, sizeof cbuf);
    struct msghdr mh;
    memset(&mh, 0, sizeof mh);
    mh.msg_iov = &iov;
    mh.msg_iovlen = 1;
    mh.msg_control = cbuf;
    mh.msg_controllen = sizeof cbuf;
    struct cmsghdr *cm = CMSG_FIRSTHDR(&mh);
    cm->cmsg_level = SOL_SOCKET;
    cm->cmsg_type = SCM_RIGHTS;
    cm->cmsg_len = CMSG_LEN(3 * sizeof(int));
    int fds[3] = {0, 1, 2};
    memcpy(CMSG_DATA(cm), fds, sizeof fds);
    if (sendmsg(fd, &mh, 0) < 0) {
        close(fd);
        fallback(argc, argv);
    }

    /* reply: one JSON line {"rc": n} | {"stale": true} */
    char rep[512];
    size_t rn = 0;
    while (rn < sizeof rep - 1) {
        ssize_t r = read(fd, rep + rn, sizeof rep - 1 - rn);
        if (r < 0 && errno == EINTR) continue;
        if (r <= 0) break;
        rn += (size_t)r;
        if (memchr(rep, '\n', rn)) break;
    }
    close(fd);
    rep[rn] = 0;
    if (!rn || strstr(rep, "\"stale\""))
        fallback(argc, argv);  /* daemon retiring / died: run direct */
    const char *rc_s = strstr(rep, "\"rc\"");
    if (!rc_s) fallback(argc, argv);
    rc_s += 4;
    while (*rc_s == ':' || *rc_s == ' ') rc_s++;
    return atoi(rc_s) & 0xFF;
}
