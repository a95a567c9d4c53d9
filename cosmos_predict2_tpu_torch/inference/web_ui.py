"""Single-page browser UI for the HTTP serving front end.

Counterpart of cosmos_predict2_tpu/inference/web_ui.py, the user-facing
side of the reference's Gradio app
(packages/cosmos-gradio/cosmos_gradio/gradio_app/gradio_app.py:26): prompt
box, optional conditioning-image upload, generation parameters, job
polling and inline playback, served as one static page over the same
endpoints (POST /generate, GET /status/<id>, GET /output/<id>, /schema).
No framework dependency: the page is a string and the interactivity is
~100 lines of vanilla JS, which keeps serving one process and zero-install
on the GPU host.
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>Cosmos Predict2 GPU</title>
<meta name="viewport" content="width=device-width, initial-scale=1">
<style>
  :root { color-scheme: light dark; }
  body { font-family: system-ui, sans-serif; max-width: 860px; margin: 2rem auto; padding: 0 1rem; }
  h1 { font-size: 1.3rem; }
  fieldset { border: 1px solid #8884; border-radius: 8px; margin-bottom: 1rem; }
  label { display: block; margin: .5rem 0 .15rem; font-size: .85rem; opacity: .8; }
  textarea, input, select { width: 100%; box-sizing: border-box; padding: .4rem; border-radius: 6px; border: 1px solid #8886; background: transparent; color: inherit; }
  textarea { min-height: 4rem; }
  .row { display: grid; grid-template-columns: repeat(auto-fit, minmax(140px, 1fr)); gap: .75rem; }
  button { padding: .55rem 1.4rem; border-radius: 6px; border: none; background: #3b82f6; color: white; font-size: 1rem; cursor: pointer; margin-top: .75rem; }
  button:disabled { opacity: .5; cursor: wait; }
  #status { margin: 1rem 0; font-family: monospace; white-space: pre-wrap; }
  #result video, #result img { max-width: 100%; border-radius: 8px; }
  .jobs { font-size: .8rem; font-family: monospace; }
</style>
</head>
<body>
<h1>Cosmos Predict2 &mdash; GPU world model serving</h1>
<form id="f">
  <fieldset>
    <label>Prompt</label>
    <textarea id="prompt" placeholder="A robot arm pours coffee into a mug..."></textarea>
    <label>Negative prompt (optional)</label>
    <textarea id="negative_prompt"></textarea>
    <label>Conditioning image / video frame (optional &mdash; Image2World)</label>
    <input type="file" id="image" accept="image/*">
  </fieldset>
  <fieldset>
    <div class="row">
      <div><label>Frames</label><input id="num_output_frames" type="number" value="77" min="1"></div>
      <div><label>Steps</label><input id="num_steps" type="number" value="35" min="1" max="200"></div>
      <div><label>Guidance</label><input id="guidance" type="number" value="7" step="0.5" min="0" max="30"></div>
      <div><label>Seed</label><input id="seed" type="number" value="1" min="0"></div>
      <div><label>Cond. frames</label><select id="num_conditional_frames">
        <option value="0">0 (Text2World)</option><option value="1" selected>1 (Image2World)</option><option value="2">2 (Video2World)</option>
      </select></div>
      <div><label>Sampler</label><select id="sampler">
        <option value="unipc" selected>UniPC (35-step CFG)</option><option value="dmd2">DMD2 (4-step distilled)</option>
      </select></div>
    </div>
  </fieldset>
  <button id="go" type="submit">Generate</button>
</form>
<div id="status"></div>
<div id="result"></div>
<script>
const $ = id => document.getElementById(id);
async function fileToB64(file) {
  return new Promise((res, rej) => {
    const r = new FileReader();
    r.onload = () => res(r.result);  // data URL
    r.onerror = rej;
    r.readAsDataURL(file);
  });
}
$("f").addEventListener("submit", async (ev) => {
  ev.preventDefault();
  $("go").disabled = true;
  $("result").innerHTML = "";
  const payload = {
    prompt: $("prompt").value,
    negative_prompt: $("negative_prompt").value,
    num_output_frames: +$("num_output_frames").value,
    num_steps: +$("num_steps").value,
    guidance: +$("guidance").value,
    seed: +$("seed").value,
    num_conditional_frames: +$("num_conditional_frames").value,
    sampler: $("sampler").value,
  };
  const file = $("image").files[0];
  if (file) payload.input_image_b64 = await fileToB64(file);
  $("status").textContent = "submitting...";
  try {
    const r = await fetch("/generate", {method: "POST", headers: {"Content-Type": "application/json"}, body: JSON.stringify(payload)});
    const j = await r.json();
    if (!r.ok) throw new Error(j.error || r.statusText);
    poll(j.job_id);
  } catch (e) {
    $("status").textContent = "error: " + e.message;
    $("go").disabled = false;
  }
});
async function poll(id) {
  const t0 = Date.now();
  let misses = 0;
  const tick = async () => {
    try {
      const r = await fetch("/status/" + id);
      const j = await r.json();
      if (r.status === 404) {
        // unknown job: the in-memory job table was lost (server restart) —
        // the job will never come back, stop quickly
        misses += 30;
        throw new Error(j.error || "unknown job");
      }
      if (!r.ok) throw new Error(j.error || r.statusText);
      misses = 0;
      const dt = ((Date.now() - t0) / 1000).toFixed(0);
      $("status").textContent = `job ${id}: ${j.status} (${dt}s)` + (j.error ? "\\n" + j.error : "");
      if (j.status === "done") {
        $("go").disabled = false;
        const url = "/output/" + id;
        const head = await fetch(url, {method: "HEAD"});
        const type = head.headers.get("Content-Type") || "";
        $("result").innerHTML = type.startsWith("video")
          ? `<video src="${url}" controls autoplay loop muted></video>`
          : `<img src="${url}">`;
        return;
      }
      if (j.status === "error") { $("go").disabled = false; return; }
    } catch (e) {
      // transient fetch failure (server restart, network blip): keep polling
      misses += 1;
      $("status").textContent = `job ${id}: polling... (${misses} missed)`;
      if (misses > 150) { $("status").textContent += " — giving up"; $("go").disabled = false; return; }
    }
    setTimeout(tick, 2000);
  };
  tick();
}
</script>
</body>
</html>
"""
