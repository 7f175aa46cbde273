/* Upload -> canvas bbox annotation -> SSE streaming -> results.
 * Plain-canvas rewrite of the reference's Konva-based UI flow
 * (upload, per-system boxes with select/move/resize/delete — the reference's
 * Konva Transformer + delete-button interactions, annotate_img.js:45-140 —
 * EventSource token stream, postprocess). */

let tmpdir = null;
let boxes = [];          // [[x0,y0,x1,y1]] in image coordinates
let img = new Image();
let scale = 1;
let drawing = null;      // new box being dragged out
let selected = -1;       // index into boxes, -1 = none
let action = null;       // {mode: "move"|"resize", corner, start, orig}
let events = null;
const HANDLE = 8;        // corner anchor size, canvas px (Konva anchorSize 12)

const $ = (id) => document.getElementById(id);

async function api(path, opts = {}) {
  opts.headers = Object.assign({}, opts.headers, tmpdir ? { "X-Tmpdir": tmpdir } : {});
  const r = await fetch(path, opts);
  if (!r.ok) throw new Error(`${path}: ${r.status}`);
  return r.json();
}

$("upload-btn").onclick = async () => {
  const f = $("file-input").files[0];
  if (!f) return alert("Choose an image first");
  ({ tmpdir } = await api("/tmpdir/create", { method: "POST" }));
  const form = new FormData();
  form.append("image", f);
  await api("/upload", { method: "POST", body: form });
  img = new Image();
  img.onload = () => {
    const canvas = $("annotate-canvas");
    scale = Math.min(1, 1000 / img.width);
    canvas.width = img.width * scale;
    canvas.height = img.height * scale;
    boxes = [];
    selected = -1;
    draw();
    $("annotate-section").hidden = false;
  };
  img.src = URL.createObjectURL(f);
};

const corners = ([x0, y0, x1, y1]) =>
  [[x0, y0], [x1, y0], [x0, y1], [x1, y1]];

function draw() {
  const canvas = $("annotate-canvas");
  const ctx = canvas.getContext("2d");
  ctx.drawImage(img, 0, 0, canvas.width, canvas.height);
  ctx.lineWidth = 2;
  boxes.forEach(([x0, y0, x1, y1], i) => {
    ctx.strokeStyle = i === selected ? "#39f" : "#e33";
    ctx.strokeRect(x0 * scale, y0 * scale, (x1 - x0) * scale, (y1 - y0) * scale);
    ctx.fillStyle = "#e33";
    ctx.font = "bold 14px sans-serif";
    ctx.fillText(String(i + 1), x0 * scale + 4, y0 * scale + 16);
    if (i === selected) {   // corner resize anchors
      ctx.fillStyle = "#39f";
      for (const [cx, cy] of corners(boxes[i]))
        ctx.fillRect(cx * scale - HANDLE / 2, cy * scale - HANDLE / 2, HANDLE, HANDLE);
    }
  });
  if (drawing) {
    ctx.strokeStyle = "#39f";
    const [x0, y0, x1, y1] = drawing;
    ctx.strokeRect(x0 * scale, y0 * scale, (x1 - x0) * scale, (y1 - y0) * scale);
  }
  $("delete-box").disabled = selected < 0;
}

const canvasPos = (e) => {
  const r = $("annotate-canvas").getBoundingClientRect();
  return [(e.clientX - r.left) / scale, (e.clientY - r.top) / scale];
};

const normBox = ([x0, y0, x1, y1]) =>
  [Math.min(x0, x1), Math.min(y0, y1), Math.max(x0, x1), Math.max(y0, y1)];

function hitCorner(i, x, y) {
  const tol = HANDLE / scale;
  let hit = -1;
  corners(boxes[i]).forEach(([cx, cy], c) => {
    if (Math.abs(x - cx) <= tol && Math.abs(y - cy) <= tol) hit = c;
  });
  return hit;
}

const hitBox = (x, y) => boxes.findIndex(
  ([x0, y0, x1, y1]) => x >= x0 && x <= x1 && y >= y0 && y <= y1);

$("annotate-canvas").onmousedown = (e) => {
  const [x, y] = canvasPos(e);
  if (selected >= 0) {      // resize via a corner anchor of the selected box
    const c = hitCorner(selected, x, y);
    if (c >= 0) {
      action = { mode: "resize", corner: c, orig: boxes[selected].slice() };
      return;
    }
  }
  const i = hitBox(x, y);   // click selects; drag moves (Konva draggable)
  if (i >= 0) {
    selected = i;
    action = { mode: "move", start: [x, y], orig: boxes[i].slice() };
    draw();
    return;
  }
  selected = -1;            // empty area: deselect and draw a new box
  drawing = [x, y, x, y];
  draw();
};
$("annotate-canvas").onmousemove = (e) => {
  const [x, y] = canvasPos(e);
  if (action && action.mode === "move") {
    const [dx, dy] = [x - action.start[0], y - action.start[1]];
    const [x0, y0, x1, y1] = action.orig;
    boxes[selected] = [x0 + dx, y0 + dy, x1 + dx, y1 + dy];
    draw();
  } else if (action && action.mode === "resize") {
    const b = action.orig.slice();
    // corner c moves with the cursor; the opposite corner stays anchored
    if (action.corner === 0) { b[0] = x; b[1] = y; }
    else if (action.corner === 1) { b[2] = x; b[1] = y; }
    else if (action.corner === 2) { b[0] = x; b[3] = y; }
    else { b[2] = x; b[3] = y; }
    boxes[selected] = normBox(b);
    draw();
  } else if (drawing) {
    drawing[2] = x; drawing[3] = y;
    draw();
  }
};
// window-level: releasing the button OUTSIDE the canvas must still end
// the drag, or the box keeps following the cursor on re-entry
window.addEventListener("mouseup", () => {
  action = null;
  if (!drawing) return;
  let [x0, y0, x1, y1] = drawing;
  drawing = null;
  if (Math.abs(x1 - x0) > 8 && Math.abs(y1 - y0) > 8) {
    boxes.push(normBox([x0, y0, x1, y1]));
    selected = boxes.length - 1;
  }
  draw();
});

function deleteSelected() {
  if (selected < 0) return;
  boxes.splice(selected, 1);
  selected = -1;
  draw();
}
$("delete-box").onclick = deleteSelected;
document.addEventListener("keydown", (e) => {
  if ((e.key === "Delete" || e.key === "Backspace")
      && document.activeElement.tagName !== "INPUT") {
    deleteSelected();
    e.preventDefault();
  }
});
$("clear-boxes").onclick = () => { boxes = []; selected = -1; draw(); };

// status line with an optional pulsing dot loader (styles in main.css)
function setStatus(text, busy) {
  const el = $("status");
  el.textContent = text;
  if (busy) {
    const dots = document.createElement("span");
    dots.className = "dots";
    for (let i = 0; i < 3; i++) dots.appendChild(document.createElement("span"));
    el.appendChild(dots);
  }
}

// append a streamed chunk as its own span so it fades in (.tok in main.css)
function appendTokens(text) {
  const span = document.createElement("span");
  span.className = "tok";
  span.textContent = text;
  $("token-stream").appendChild(span);
  $("token-stream").scrollTop = $("token-stream").scrollHeight;
}

$("run-btn").onclick = async () => {
  try {
    await api("/inference/setup", {
      method: "POST",
      headers: { "Content-Type": "application/json" },
      body: JSON.stringify({ bboxes: boxes }),
    });
  } catch (err) {
    setStatus(`Setup failed: ${err.message || err}`, false);
    return;
  }
  $("stream-section").hidden = false;
  $("token-stream").textContent = "";
  setStatus("Encoding…", true);
  events = new EventSource(`/inference/stream?tmpdir=${encodeURIComponent(tmpdir)}`);
  events.addEventListener("encoding_start", () => setStatus("Encoding image…", true));
  events.addEventListener("encoding_finish", () => setStatus("Decoding…", true));
  events.addEventListener("step", (e) => {
    const d = JSON.parse(e.data);
    appendTokens(d.tokens.join(" ") + " ");
  });
  events.addEventListener("inference_finish", (e) => {
    const d = JSON.parse(e.data);
    appendTokens(`\n--- system ${d.system + 1} done ---\n`);
  });
  events.addEventListener("all_inference_finish", async () => {
    events.close();
    setStatus("Post-processing…", true);
    let res;
    try {
      res = await api("/inference/postprocess", { method: "POST" });
    } catch (err) {
      // an uncaught rejection left the page hanging on "Post-processing…"
      setStatus(`Post-processing failed: ${err.message || err}`, false);
      return;
    }
    setStatus("Done", false);
    $("result-section").hidden = false;
    if (res.ok) {
      $("confidence").textContent = res.confidence != null
        ? `Confidence: ${(res.confidence * 100).toFixed(1)}%` : "";
      $("rendered").innerHTML = "";
      for (const b64 of res.rendered_images) {
        const im = document.createElement("img");
        im.src = `data:image/png;base64,${b64}`;
        $("rendered").appendChild(im);
      }
    } else {
      $("confidence").textContent = `Delinearization failed: ${res.error}`;
    }
  });
  events.onerror = () => { setStatus("Stream error", false); events.close(); };
};

$("download-btn").onclick = () => {
  window.location = `/download?tmpdir=${encodeURIComponent(tmpdir)}`;
};
$("reset-btn").onclick = async () => {
  try { await api("/clear", { method: "POST" }); } catch (e) {}
  window.location.reload();
};
